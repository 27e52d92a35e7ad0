"""Image entropy via ViT-MAE masked-reconstruction error.

Counterpart of ``dewi_tpu/signals/image_entropy.py``: ``score(image)`` is
the per-image masked-patch MSE, ``batch_compute_stats`` the per-image mean
and q90 of the per-patch losses, and without a model (``model_name=
"pixel"``) a luma ``var/mean^2`` proxy stands in.  Images travel as uint8
and are scaled to [0, 1] on the device.

The masking noise of batch ``b`` comes from a generator seeded from
``(seed, b * batch_size)``, as the reference folds ``b * batch_size`` into
its key, so a value does not depend on how batches are grouped.  PyTorch's
random stream is not JAX's: for the same seed the masks, and so the values,
differ from the reference's.

Under a ``mesh`` each batch runs data-parallel (``parallel.DataParallel``):
the masking noise is drawn for the whole padded batch, each rank runs the
MAE on its slice of the rows and noise, and the per-patch losses and masks
are gathered back before the aggregates, so a document's mask and value do
not depend on the number of ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..io.images import Batch, ImageLike, decode_image_uint8, iter_corpus_batches, resize_f32
from ..models.import_hf import sidecar_config
from ..models.mae import MAEConfig, pixel_entropy_proxy, pixel_patch_proxy
from ..models.registry import init_mae, mae_config, maybe_load
from ..ops.robust import masked_mean_and_quantiles
from ..parallel.signals import DataParallel
from ..utils.device import DeviceLike


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] by the float32 constant 1/255 (the
    reference's multiply, not a divide); floats pass through as float32."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) * (1.0 / 255.0)
    return images.to(torch.float32)


def to_image_array(image: ImageLike, size: int) -> np.ndarray:
    """Decode/resize any supported input to ``[size, size, 3]`` f32 in [0,1].

    Float arrays stay float end to end (bilinear resize in f32); everything
    else goes through the uint8 decoder.
    """
    if (
        isinstance(image, np.ndarray)
        and image.ndim in (2, 3)
        and image.dtype != np.uint8
        and (image.ndim == 2 or image.shape[-1] == 3)
    ):
        arr = np.asarray(image, dtype=np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.size and float(arr.max()) > 1.5:  # uint8-range floats
            arr = arr / 255.0
        return resize_f32(arr, size)
    return decode_image_uint8(image, size).astype(np.float32) / 255.0


def to_f32_batch(batch: Batch) -> torch.Tensor:
    """A batch as float32 in [0, 1] for the model-free proxies (float batches
    in uint8 range scale down too)."""
    b = torch.as_tensor(batch)
    if b.dtype == torch.uint8:
        return b.to(torch.float32) / 255.0
    b = b.to(torch.float32)
    if b.numel() and float(b.max()) > 1.5:
        b = b / 255.0
    return b


def batch_generator(seed: int, offset: int, device: torch.device) -> torch.Generator:
    """The masking generator of the batch that starts at image ``offset``:
    seeded from ``(seed, offset)``, the reference's ``fold_in``."""
    state = np.random.SeedSequence([int(seed), int(offset)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class ImageEntropyEstimator:
    """MAE reconstruction-loss estimator with batched inference.

    ``images`` arguments take paths, PIL images or arrays (decoded one by
    one), a pre-decoded ``[N, S, S, 3]`` ndarray or tensor at the
    estimator's resolution, or a :class:`DeviceImages` corpus.  Pass
    ``model_name="pixel"`` for the variance-proxy fallback.  ``device=None``
    runs on the card, or on the mesh's device under ``mesh=`` (data-parallel
    batches, the batch size rounded up to a multiple of the data axis).
    """

    def __init__(
        self,
        model_name: str = "small",
        device: DeviceLike = None,
        mask_ratio: float = 0.75,
        patch_size: Optional[int] = None,
        image_size: Optional[int] = None,
        batch_size: int = 64,
        checkpoint: Optional[str] = None,
        seed: int = 0,
        mesh: Any = None,
        **_: object,
    ) -> None:
        self._dp = DataParallel(mesh, device)
        self.device = self._dp.device
        self.batch_size = self._dp.round_batch(batch_size)
        self.mask_ratio = float(mask_ratio)
        if model_name in ("pixel", "none", "proxy"):
            self.model = None
            self.cfg = None
            self.image_size = int(image_size or 224)
            return
        side = sidecar_config(checkpoint)
        if side is not None:
            # The sidecar defines the architecture; mask_ratio stays tunable.
            self.cfg = dataclasses.replace(MAEConfig(**side["config"]),
                                           mask_ratio=self.mask_ratio)
        else:
            over: dict = {"mask_ratio": self.mask_ratio}
            if patch_size:
                over["patch_size"] = int(patch_size)
            if image_size:
                over["image_size"] = int(image_size)
            self.cfg = mae_config(model_name, **over)
        self.image_size = self.cfg.image_size
        self.model = maybe_load(init_mae(self.cfg, seed=seed, device=self.device), checkpoint)
        self._dp.replicate(self.model)

    def _batch_noise(self, seed: int, offset: int, rows: int) -> torch.Tensor:
        """The masking noise ``[rows, P]`` of the batch that starts at image
        ``offset``: the draw ``patch_losses`` makes from that generator."""
        return torch.rand((rows, self.cfg.num_patches),
                          generator=batch_generator(seed, offset, self.device),
                          device=self.device)

    @torch.no_grad()
    def _patch_losses(self, chunk: Any, seed: int, offset: int) -> tuple:
        """Per-patch losses and masks of the whole batch; under a mesh the
        noise of the whole batch is drawn, then sliced with the rows."""
        noise = self._batch_noise(seed, offset, chunk.shape[0])
        per_patch, mask = self.model.patch_losses(normalize_images(self._dp.put(chunk)),
                                                  noise=self._dp.put(noise))
        return self._dp.gather(per_patch), self._dp.gather(mask)

    # -- public API -----------------------------------------------------------

    def score(self, image: ImageLike, seed: int = 0) -> float:
        """Single-image reconstruction MSE (the patch mask is seeded)."""
        return self.batch_compute([image], seed=seed)[0]

    @torch.no_grad()
    def batch_compute(self, images: Sequence[ImageLike], seed: int = 0,
                      batch_size: Optional[int] = None) -> List[float]:
        if not len(images):
            return []
        bs = self._dp.round_batch(batch_size or self.batch_size)
        out: List[torch.Tensor] = []
        for b, (chunk, pad) in enumerate(iter_corpus_batches(images, self.image_size, bs)):
            if self.model is None:
                chunk = torch.as_tensor(chunk).to(self.device)
                out.append(pixel_entropy_proxy(to_f32_batch(chunk))[:bs - pad])
                continue
            per_patch, mask = self._patch_losses(chunk, seed, b * bs)
            losses = (per_patch * mask).sum(1) / mask.sum(1).clamp_min(1.0)
            out.append(losses[:bs - pad])
        return [float(v) for v in torch.cat(out).cpu().numpy()]

    @torch.no_grad()
    def batch_compute_stats(
        self, images: Sequence[ImageLike], seed: int = 0,
        batch_size: Optional[int] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> tuple:
        """Per-image ``(mean, q90)`` float32 arrays of the patch
        reconstruction error; the aggregates stay on the device until one
        copy at the end."""
        if not len(images):
            return np.zeros(0, np.float32), np.zeros(0, np.float32)
        bs = self._dp.round_batch(batch_size or self.batch_size)
        q90 = torch.tensor([0.9], dtype=torch.float32, device=self.device)
        means: List[torch.Tensor] = []
        q90s: List[torch.Tensor] = []
        for b, (chunk, pad) in enumerate(iter_corpus_batches(images, self.image_size, bs)):
            if self.model is None:
                chunk = torch.as_tensor(chunk).to(self.device)
                per_patch = pixel_patch_proxy(to_f32_batch(chunk))
                mean, q = per_patch.mean(dim=1), torch.quantile(per_patch, 0.9, dim=1)
            else:
                mean, qs = masked_mean_and_quantiles(*self._patch_losses(chunk, seed, b * bs), q90)
                q = qs[:, 0]
            means.append(mean[:bs - pad])
            q90s.append(q[:bs - pad])
            if progress is not None:
                progress(bs - pad)
        return (torch.cat(means).cpu().numpy().astype(np.float32),
                torch.cat(q90s).cpu().numpy().astype(np.float32))

    def __call__(self, image: ImageLike, **kwargs: Any) -> float:
        return self.score(image, **kwargs)


__all__ = ["ImageEntropyEstimator", "normalize_images", "to_f32_batch", "to_image_array",
           "batch_generator", "ImageLike"]
