"""Data: the corpora, the IMDB examples and the electricity series with
their synthetic stand-ins, contiguous [B, T] LM batching, padded
classification batches, forecast windows and the K-step feeds (host,
numpy); the data staged on the device and the prefetched host feed
(``device_dataset``, ``prefetch``)."""

from .batching import (cap_batches, epoch_stream, example_order,
                       forecast_starts, forecast_windows, index_groups,
                       lm_batch_stream, lm_epoch_batches, lm_windows,
                       padded_batches, stacked_batches)
from .device_dataset import (DeviceExamples, DeviceLMData, DeviceSeries,
                             slice_forecast_batch, slice_window,
                             stage_examples, stage_lm_data, stage_series,
                             stage_stacked_batches, take_batch,
                             window_index_stream)
from .prefetch import prefetch_to_device
from .corpus import (Vocab, build_char_vocab, build_word_vocab, load_text,
                     synthetic_text)
from .datasets import get_dataset

__all__ = ["DeviceExamples", "DeviceLMData", "DeviceSeries", "Vocab",
           "build_char_vocab", "build_word_vocab", "cap_batches",
           "epoch_stream", "example_order", "forecast_starts",
           "forecast_windows", "get_dataset", "index_groups",
           "lm_batch_stream", "lm_epoch_batches", "lm_windows", "load_text",
           "padded_batches", "prefetch_to_device", "slice_forecast_batch",
           "slice_window", "stacked_batches", "stage_examples",
           "stage_lm_data", "stage_series", "stage_stacked_batches",
           "synthetic_text", "take_batch", "window_index_stream"]
