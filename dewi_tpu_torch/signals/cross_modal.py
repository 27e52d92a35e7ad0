"""Cross-modal dependency (text-image mutual-information proxy) via CLIP.

Counterpart of ``dewi_tpu/signals/cross_modal.py``: both towers embed a
batch each, and a pair's score is the cosine of its two L2-normalized
embeddings (the diagonal of the text x image similarity matrix).  The text
tower is also the query encoder of search (``serve.SearchServer``).

Under a ``mesh`` both towers run data-parallel (``parallel.DataParallel``):
each rank embeds its slice of every padded batch and the embeddings are
gathered back into the whole batch on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..io.images import iter_corpus_batches
from ..models.clip import CLIPConfig
from ..models.import_hf import sidecar_config
from ..models.registry import clip_config, init_clip, maybe_load
from ..parallel.signals import DataParallel
from ..utils.device import DeviceLike
from .image_entropy import ImageLike, normalize_images
from .tokenizer import get_tokenizer


@dataclass
class CrossModalResult:
    info_nce_score: float
    text_to_image_sim: float
    image_to_text_sim: float


class CrossModalDependency:
    """CLIP text-image cosine similarity as an InfoNCE MI lower-bound proxy.

    ``device=None`` runs on the card, or on the mesh's device under
    ``mesh=`` (data-parallel towers, the batch size rounded up to a
    multiple of the data axis).
    """

    def __init__(
        self,
        model_name: str = "small",
        device: DeviceLike = None,
        batch_size: int = 128,
        tokenizer: Any = "byte",
        checkpoint: Optional[str] = None,
        seed: int = 0,
        image_size: Optional[int] = None,
        mesh: Any = None,
    ) -> None:
        self._dp = DataParallel(mesh, device)
        self.device = self._dp.device
        self.batch_size = self._dp.round_batch(batch_size)
        self.tokenizer = get_tokenizer(tokenizer)
        side = sidecar_config(checkpoint)
        if side is not None:
            self.cfg = CLIPConfig(**side["config"])
            if image_size is not None and int(image_size) != self.cfg.image_size:
                raise ValueError(
                    f"cross_modal.image_size={image_size} conflicts with "
                    f"checkpoint {checkpoint!r} (trained at "
                    f"{self.cfg.image_size}px; its positional embeddings "
                    f"fix the resolution). Drop the override or the checkpoint."
                )
            if self.cfg.vocab_size != self.tokenizer.vocab_size:
                raise ValueError(
                    f"CLIP checkpoint {checkpoint!r} expects a "
                    f"{self.cfg.vocab_size}-token vocabulary but tokenizer "
                    f"{tokenizer!r} has {self.tokenizer.vocab_size}. "
                    f"Configure the matching tokenizer (cross_modal/text config)."
                )
        else:
            over = {}
            if image_size is not None:
                patch = clip_config(model_name).patch_size
                if int(image_size) % patch:
                    raise ValueError(
                        f"cross_modal.image_size={image_size} is not a multiple "
                        f"of the {model_name!r} patch size ({patch})."
                    )
                over["image_size"] = int(image_size)
            self.cfg = clip_config(model_name, vocab_size=self.tokenizer.vocab_size, **over)
        self.model = maybe_load(init_clip(self.cfg, seed=seed, device=self.device), checkpoint)
        self._dp.replicate(self.model)

    # -- encoders (shared with search) ------------------------------------------

    @torch.no_grad()
    def encode_texts_tensor(self, texts: Sequence[str],
                            progress: Optional[Callable[[int], None]] = None) -> torch.Tensor:
        """L2-normalized text embeddings ``[N, d_embed]`` on the device.

        Batches are padded to ``batch_size`` rows with empty masks."""
        bs, tl = self.batch_size, self.cfg.text_len
        out: List[torch.Tensor] = []
        for s in range(0, len(texts), bs):
            chunk = list(texts[s:s + bs])
            ids = np.full((bs, tl), self.tokenizer.pad_id, np.int32)
            mask = np.zeros((bs, tl), np.float32)
            ids[:len(chunk)], mask[:len(chunk)] = self.tokenizer.encode_batch(chunk, tl, pad_to=tl)
            e = self._dp.gather(self.model.encode_text(self._dp.put(ids).long(),
                                                       self._dp.put(mask)))
            out.append(e[:len(chunk)])
            if progress is not None:
                progress(len(chunk))
        if not out:
            return torch.zeros((0, self.cfg.d_embed), device=self.device)
        return torch.cat(out)

    @torch.no_grad()
    def encode_images_tensor(self, images: Sequence[ImageLike],
                             progress: Optional[Callable[[int], None]] = None) -> torch.Tensor:
        """L2-normalized image embeddings ``[N, d_embed]`` on the device."""
        bs = self.batch_size
        out: List[torch.Tensor] = []
        for chunk, pad in iter_corpus_batches(images, self.cfg.image_size, bs):
            e = self._dp.gather(self.model.encode_image(normalize_images(self._dp.put(chunk))))
            out.append(e[:bs - pad])
            if progress is not None:
                progress(bs - pad)
        if not out:
            return torch.zeros((0, self.cfg.d_embed), device=self.device)
        return torch.cat(out)

    def encode_texts(self, texts: Sequence[str],
                     progress: Optional[Callable[[int], None]] = None) -> np.ndarray:
        """L2-normalized text embeddings ``[N, d_embed]`` float32, on the host."""
        return self.encode_texts_tensor(texts, progress).cpu().numpy()

    def encode_images(self, images: Sequence[ImageLike],
                      progress: Optional[Callable[[int], None]] = None) -> np.ndarray:
        """L2-normalized image embeddings ``[N, d_embed]`` float32, on the host."""
        return self.encode_images_tensor(images, progress).cpu().numpy()

    # -- public API -----------------------------------------------------------

    def compute_similarity(self, text: str, image: ImageLike) -> CrossModalResult:
        """Single text-image pair."""
        return self.batch_compute([text], [image])[0]

    def batch_compute(self, texts: Sequence[str], images: Sequence[ImageLike],
                      batch_size: Optional[int] = None,
                      progress: Optional[Callable[[int], None]] = None
                      ) -> List[CrossModalResult]:
        """Per-pair cosine (the diagonal of the text x image matrix)."""
        if len(texts) != len(images):
            raise ValueError("Number of texts and images must match")
        if not len(texts):
            return []
        if batch_size is not None:
            self.batch_size = self._dp.round_batch(batch_size)
        return [CrossModalResult(float(s), float(s), float(s))
                for s in self.batch_diagonal(texts, images, progress=progress)]

    def batch_diagonal(self, texts: Sequence[str], images: Sequence[ImageLike],
                       progress: Optional[Callable[[int], None]] = None) -> np.ndarray:
        """Per-pair cosine as one ``[N]`` float32 array."""
        t = self.encode_texts_tensor(texts)
        v = self.encode_images_tensor(images, progress=progress)
        return (t * v).sum(dim=1).cpu().numpy().astype(np.float32)

    def similarity_matrix(self, texts: Sequence[str], images: Sequence[ImageLike]) -> np.ndarray:
        """Full ``[N, M]`` text x image cosine matrix."""
        return (self.encode_texts_tensor(texts) @ self.encode_images_tensor(images).T).cpu().numpy()

    def __call__(self, text: str, image: ImageLike) -> CrossModalResult:
        return self.compute_similarity(text, image)


__all__ = ["CrossModalDependency", "CrossModalResult"]
