"""Host data pipeline: protocol parsing, audio decoding, the decode-once
waveform cache, balanced batches, host RawBoost and a prefetching
producer thread."""

from .audio import AudioConfig, AudioLoader, load_waveform, pad_or_trim
from .pipeline import (Batch, BatchPipeline, prefetch_to_device,
                       stream_through_device)
from .protocols import (SpoofDataset, Utterance, parse_asvspoof2019,
                        parse_asvspoof2021, parse_common_voice,
                        parse_famous_figures, parse_in_the_wild,
                        parse_ravdess)
from .rawboost import RawBoostParams, apply_rawboost, apply_rawboost_batch
from .sampler import BalancedBatchSampler

__all__ = ["AudioConfig", "AudioLoader", "load_waveform", "pad_or_trim",
           "Batch", "BatchPipeline", "prefetch_to_device",
           "stream_through_device", "SpoofDataset",
           "Utterance", "parse_asvspoof2019", "parse_asvspoof2021",
           "parse_common_voice", "parse_famous_figures", "parse_in_the_wild",
           "parse_ravdess",
           "RawBoostParams", "apply_rawboost", "apply_rawboost_batch",
           "BalancedBatchSampler"]
