"""Image input of the port: decode/resize helpers and device-resident corpora."""

from .device_images import DeviceImages
from .images import decode_image_uint8, iter_corpus_batches, resize_f32, resize_uint8

__all__ = ["DeviceImages", "decode_image_uint8", "iter_corpus_batches", "resize_f32",
           "resize_uint8"]
