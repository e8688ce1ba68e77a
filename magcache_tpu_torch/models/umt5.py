"""UMT5 text encoder (umt5-xxl, Wan's text conditioning): the names of
``magcache_tpu.models.umt5``'s port, kept for its callers.

UMT5 is the T5-family encoder of ``models/t5.py`` with a relative-position
bias in every layer (``UMT5Config.per_layer_bias``); ``models.text.T5Encoder``
encodes prompts with it.
"""

from magcache_tpu_torch.models.t5 import (UMT5_XXL, T5Model, UMT5Config,
                                          relative_position_buckets, t5_encode)
from magcache_tpu_torch.models.text import T5Encoder

__all__ = ["UMT5Config", "UMT5Model", "UMT5Encoder", "UMT5_XXL", "umt5_encode",
           "relative_position_buckets"]

UMT5Model = T5Model
UMT5Encoder = T5Encoder
umt5_encode = t5_encode
