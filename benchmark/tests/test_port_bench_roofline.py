"""The operation and byte counts give hand-computed values at known shapes."""

from harness import roofline as rf


def test_bmax_s8_bytes_by_hand():
    # 2^20 rows of 256 int8 + mult/add f32 in; 32 queries of 256 s8 + 32 f32
    # scales in; [32, 8192] f32 maxima out.
    assert rf.bmax_s8_bytes(1 << 20, 256, 32) == (
        268_435_456 + 8_388_608 + 8_192 + 128 + 1_048_576)
    assert rf.bmax_s8_ops(1 << 20, 256, 32) == 2 * 32 * 256 * (1 << 20)


def test_windows_match_the_scoring_rule():
    assert rf.windows(512, 512) == [512]
    assert rf.windows(513, 512) == [512, 129]
    # 1000 tokens: starts 0, 384, 768 (range stops below 1000 - 128 = 872)
    assert rf.windows(1000, 512) == [512, 512, 232]


def test_decoder_flops_by_hand():
    # t=4, d=2, one layer, ff=8: dense 2*4*(4*4 + 2*2*8) = 384;
    # attention 2 * 2 * d * (4*5/2) = 80
    assert rf.decoder_flops(4, 2, 1, 8) == 384 + 80


def test_lm_and_clip_flops_by_hand():
    lm = {"n_embd": 2, "n_layer": 1, "n_inner": 8, "vocab_size": 3}
    assert rf.lm_flops(4, lm) == 464 + 2 * 4 * 2 * 3
    clip = {"projection_dim": 5, "text_config": {"hidden_size": 2, "num_hidden_layers": 1,
                                                 "intermediate_size": 8,
                                                 "max_position_embeddings": 3}}
    assert rf.clip_text_flops(4, clip) == 464 + 2 * 2 * 5
    # a 4-token doc: the LM over 4 tokens, CLIP over its 3-token context
    assert rf.corpus_flops([4], lm, clip, ctx=512) == rf.lm_flops(4, lm) + rf.clip_text_flops(3, clip)


def test_gpt2_forward_flops_at_published_widths():
    lm = {"n_embd": 768, "n_layer": 12, "n_inner": 3072, "vocab_size": 258}
    t = 512
    dense = 12 * 2 * t * (4 * 768 ** 2 + 2 * 768 * 3072)
    attn = 12 * 2 * 2 * 768 * (t * (t + 1) // 2)
    assert rf.lm_flops(t, lm) == dense + attn + 2 * t * 768 * 258
    assert abs(dense / t / 2 - 84.9e6) < 0.1e6  # 85M matmul parameters a token
