// Attention dropout mask of the Pallas kernel (`_random_bits`,
// `_dropout_mask`, `_head_seed` in
// wav2vec_contr_loss_tpu/ops/attention_pallas.py), computed in registers:
// the murmur3 finalizer over (query row, key column) with the per-(batch,
// head) seed `seed + b*S + h` (S, the seed stride, is H, the head count,
// unless a call holds a shard of the batch or of the heads: then the
// caller's seed names its first (batch, head) and S is the global H), all
// in uint32 arithmetic. An element is
// kept when its bits reach `threshold` (= min(rate * 2^32, 2^32 - 1)) and
// then scaled by 1 / (1 - rate); the forward and backward kernels both
// call this, so the backward regenerates the forward's mask.
#pragma once

struct DropoutMask {
  unsigned seed_term;  // seed_bh * 2246822519 + 0x85EBCA6B
  unsigned threshold;  // 0 means rate 0: every element kept, scale 1
  float scale;

  __device__ __forceinline__ DropoutMask(unsigned seed_bh, unsigned thr,
                                         float s)
      : seed_term(seed_bh * 2246822519u + 0x85EBCA6Bu), threshold(thr),
        scale(s) {}

  __device__ __forceinline__ float operator()(unsigned row,
                                              unsigned col) const {
    if (threshold == 0u) return 1.f;
    unsigned h = (row * 2654435761u) ^ (col * 0x9E3779B9u);
    h ^= seed_term;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h >= threshold ? scale : 0.f;
  }
};
