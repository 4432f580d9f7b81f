"""Host-side data: the char corpus and the IMDB examples with their
synthetic stand-ins, contiguous [B, T] LM batching and padded
classification batches (numpy only)."""

from .batching import (cap_batches, epoch_stream, example_order,
                       lm_batch_stream, lm_epoch_batches, lm_windows,
                       padded_batches)
from .corpus import (Vocab, build_char_vocab, build_word_vocab, load_text,
                     synthetic_text)
from .datasets import get_dataset

__all__ = ["Vocab", "build_char_vocab", "build_word_vocab", "cap_batches",
           "epoch_stream", "example_order", "get_dataset", "lm_batch_stream",
           "lm_epoch_batches", "lm_windows", "load_text", "padded_batches",
           "synthetic_text"]
