"""Host data pipeline: protocol parsing, audio decoding, balanced
batches, host RawBoost and a prefetching producer thread."""

from .audio import AudioConfig, AudioLoader, load_waveform, pad_or_trim
from .pipeline import (Batch, BatchPipeline, prefetch_to_device,
                       stream_through_device)
from .protocols import (SpoofDataset, Utterance, parse_asvspoof2019,
                        parse_in_the_wild)
from .rawboost import RawBoostParams, apply_rawboost, apply_rawboost_batch
from .sampler import BalancedBatchSampler

__all__ = ["AudioConfig", "AudioLoader", "load_waveform", "pad_or_trim",
           "Batch", "BatchPipeline", "prefetch_to_device",
           "stream_through_device", "SpoofDataset",
           "Utterance", "parse_asvspoof2019", "parse_in_the_wild",
           "RawBoostParams", "apply_rawboost", "apply_rawboost_batch",
           "BalancedBatchSampler"]
