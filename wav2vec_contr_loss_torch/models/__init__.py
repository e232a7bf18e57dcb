"""Encoder, compression module and stage-2 heads, in eval mode."""

from .compression import CompressionModule, clip_embedding
from .heads import LinearBinaryHead, SmallMLPBinaryHead, build_head
from .wav2vec2 import Wav2Vec2Encoder

__all__ = ["CompressionModule", "clip_embedding", "LinearBinaryHead",
           "SmallMLPBinaryHead", "build_head", "Wav2Vec2Encoder"]
