"""Signal estimators of the port: text entropy, image entropy, cross-modal,
redundancy and noise."""

from .cross_modal import CrossModalDependency, CrossModalResult
from .image_entropy import ImageEntropyEstimator
from .noise import NoiseEstimator
from .redundancy import RedundancyEstimator, max_offdiag_similarity, topk_density
from .text_entropy import TextEntropyEstimator, TextEntropyResult
from .tokenizer import ByteTokenizer, bucket_length, get_tokenizer

__all__ = ["CrossModalDependency", "CrossModalResult", "ImageEntropyEstimator",
           "NoiseEstimator", "RedundancyEstimator", "TextEntropyEstimator",
           "TextEntropyResult", "ByteTokenizer", "bucket_length", "get_tokenizer",
           "max_offdiag_similarity", "topk_density"]
