// The streaming skeleton shared by the kernels over groups of up to 16
// tokens: grouped_attention.cu's grouped_stream_kernel (K5, K5r and K4 on
// the "stream" route) and tiny_attention.cu's tiny_stream_kernel (K9).
//
// q, k and v are described by 5-D TMA maps (channel, in-group position,
// head, group, batch) over the tensors' own strides
// (ops/attention.py:stream_tma_maps); one box is 72 columns x 16 positions
// x 8 heads of one group, unswizzled, so that a head's 16 rows of 72 land
// 144 bytes apart. A stage is one group's heads 8j .. 8j + 7: one box each
// of q, k and v. Persistent blocks walk a contiguous range of stages; a
// producer warp copies them into a ring of shared-memory stages (three for
// K5's stream route, two for K9's)
// behind two mbarriers a stage ("full": the copy engine's bytes arrived;
// "empty": all kSlots consumer warps have read the stage). Positions past
// the maps' extent and heads past H arrive as zeros, without being read.

#pragma once

#include "hopper_attention.cuh"
#include "mma_tile.cuh"

namespace stream_ring {

using mc::bf16;

constexpr int kD = mc::kHD;                         // 72: a head row
constexpr int kSlots = 8;                           // heads a stage, one a consumer warp
constexpr int kThreads = (kSlots + 1) * 32;         // + the producer warp
constexpr int kRows = 16;                           // a group's rows, padded
constexpr int kSlotElems = kRows * kD;              // one tensor's rows of a task
constexpr int kBoxElems = kSlots * kSlotElems;      // one tensor's TMA box
constexpr int kStageElems = 3 * kBoxElems;          // q, k and v of 8 tasks

// q, k and v: box 72 x 16 x 8 x 1 x 1 (ops/attention.py:stream_tma_maps)
struct StreamMaps {
  CUtensorMap t[3];
};

// The three maps from their geometry words (3 x hopper::kMapWords).
inline int encode_maps(StreamMaps* m, const void* q, const void* k, const void* v,
                       const long long* words) {
  const void* base[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::encode_map(&m->t[i], base[i], words + i * hopper::kMapWords);
    if (err) return err;
  }
  return 0;
}

// 128-byte aligned start of the dynamic shared memory (the ring comes first).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 127) &
                                          ~uintptr_t(127));
}

// One thread: the barriers of a ring of kRing stages, "full" taking the
// producer's one arrival (with the bytes), "empty" one arrival of each
// consumer warp.
template <int kRing>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty) {
  for (int i = 0; i < kRing; ++i) {
    hopper::mbar_init(&full[i], 1);
    hopper::mbar_init(&empty[i], kSlots);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer (one lane): stages [s0, s1) into the ring of kRing stages,
// three boxes a stage; stage s is heads 8(s % hc) .. + 7 of group s / hc,
// and group g is group g % gpb of batch row g / gpb.
template <int kRing>
__device__ __forceinline__ void produce(const StreamMaps& maps, bf16* ring, uint64_t* full,
                                        uint64_t* empty, int s0, int s1, int hc, int gpb) {
  for (int s = s0, it = 0; s < s1; ++s, ++it) {
    const int buf = it % kRing;
    hopper::mbar_wait(&empty[buf], ((it / kRing) & 1) ^ 1);
    const int g = s / hc, h0 = (s % hc) * kSlots;
    bf16* st = ring + buf * kStageElems;
    hopper::mbar_expect_tx(&full[buf], kStageElems * 2);
#pragma unroll
    for (int x = 0; x < 3; ++x)
      hopper::tma_load_5d(st + x * kBoxElems, &maps.t[x], &full[buf], 0, 0, h0, g % gpb,
                          g / gpb);
  }
}

}  // namespace stream_ring
