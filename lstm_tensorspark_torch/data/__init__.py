"""Data: the char corpus and the IMDB examples with their synthetic
stand-ins, contiguous [B, T] LM batching, padded classification batches
and the K-step feeds (host, numpy); the corpus staged on the device and
the prefetched host feed (``device_dataset``, ``prefetch``)."""

from .batching import (cap_batches, epoch_stream, example_order,
                       index_groups, lm_batch_stream, lm_epoch_batches,
                       lm_windows, padded_batches, stacked_batches)
from .device_dataset import (DeviceExamples, DeviceLMData, slice_window,
                             stage_examples, stage_lm_data,
                             stage_stacked_batches, take_batch,
                             window_index_stream)
from .prefetch import prefetch_to_device
from .corpus import (Vocab, build_char_vocab, build_word_vocab, load_text,
                     synthetic_text)
from .datasets import get_dataset

__all__ = ["DeviceExamples", "DeviceLMData", "Vocab", "build_char_vocab",
           "build_word_vocab", "cap_batches", "epoch_stream", "example_order",
           "get_dataset", "index_groups", "lm_batch_stream",
           "lm_epoch_batches", "lm_windows", "load_text", "padded_batches",
           "prefetch_to_device", "slice_window", "stacked_batches",
           "stage_examples", "stage_lm_data", "stage_stacked_batches",
           "synthetic_text", "take_batch", "window_index_stream"]
