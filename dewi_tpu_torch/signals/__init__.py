"""Signal estimators of the port: text entropy, image entropy, cross-modal."""

from .cross_modal import CrossModalDependency, CrossModalResult
from .image_entropy import ImageEntropyEstimator
from .text_entropy import TextEntropyEstimator, TextEntropyResult
from .tokenizer import ByteTokenizer, bucket_length, get_tokenizer

__all__ = ["CrossModalDependency", "CrossModalResult", "ImageEntropyEstimator",
           "TextEntropyEstimator", "TextEntropyResult", "ByteTokenizer", "bucket_length",
           "get_tokenizer"]
