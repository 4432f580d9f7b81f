"""Host-side data for LM training: the char corpus, its synthetic stand-in,
and contiguous [B, T] batching (numpy only)."""

from .batching import cap_batches, lm_batch_stream, lm_epoch_batches, lm_windows
from .corpus import Vocab, build_char_vocab, load_text, synthetic_text
from .datasets import get_dataset

__all__ = ["Vocab", "build_char_vocab", "cap_batches", "get_dataset",
           "lm_batch_stream", "lm_epoch_batches", "lm_windows", "load_text",
           "synthetic_text"]
