"""Image input of the port: threaded decode, prefetch, the decode-once cache,
packed corpora and device-resident corpora."""

from .device_images import DeviceImages, device_images_or_none
from .images import (ImageCache, decode_batch, decode_image_uint8, iter_corpus_batches,
                     iter_padded_batches, resize_f32, resize_uint8)
from .packed import PackedImages, is_packed_corpus, pack_images

__all__ = ["DeviceImages", "ImageCache", "PackedImages", "decode_batch", "decode_image_uint8",
           "device_images_or_none", "is_packed_corpus", "iter_corpus_batches",
           "iter_padded_batches", "pack_images", "resize_f32", "resize_uint8"]
