// One warp-specialised attention body for Hopper (sm_90a): TMA copies into
// a ring of shared-memory stages, wgmma on the tensor cores. Instantiated
// by flash_attention.cu (K1, K1b, K1c: head dim 128; K1q: head dim 72
// carried as 80, fixed max, on its pre-pass's normed q and k) and by
// grouped_attention.cu in the grouped geometry (head dim 72 carried as 80:
// K5r and K4 with the row max on the q/k/v views; K5 and K4 with gains or
// RoPE, fixed max or row max, on the pre-pass's q^ and k^). hopper_cross_kernel below, K6's attention stage
// (stdit3_kernels.cu), reuses its parts with K and V resident.
//
// Replaces the TPU kernels magcache_tpu/ops/attention.py:flash_attention_bshd,
// flash_attention_bhsd and flash_attention_bhsd_aux (bodies _flash_kernel*)
// and, for groups of more than 16 tokens, _grouped_kernel
// (grouped_attention_fused_qkv and grouped_flash_attention_bshd). What each
// computes, and where it rounds, is stated in the .cu file that
// instantiates it; the modes here:
//   kFixed    p = exp2(min(s, m + 126) - m) with the constant m; no rescale.
//   kRunning  the online softmax: m_new = max(m_old, tile max), the
//             accumulator and l scaled by exp2(m_old - m_new).
//   kAux      kRunning on scores scaled after the product (q is not
//             pre-scaled), returning m (natural base) and l.
//   kRowMax   a first pass of QK^T over the whole key range for each row's
//             true max, then kFixed's loop with that max as each row's
//             shift: p = exp2(s - rowmax) is rounded to bf16 once, exactly
//             as the one-shot softmax of the TPU kernel rounds it.
//
// Block: 3 warpgroups, 384 threads, one block per SM. Warpgroup 0 is the
// producer: setmaxnreg drops it to 40 registers and one thread issues every
// TMA copy (cp.async.bulk.tensor) - the block's 128 query rows once, then
// 128-key tiles of K and V into a ring of kStages stages (3 at head dim
// 128, 4 at 80), each stage with a "full" mbarrier (the copy's bytes) and
// an "empty" one (the 8 consumer warps). Warpgroups 1 and 2 are consumers
// (setmaxnreg 232; ptxas still fits their code in the kernel's 168
// registers), 64 query rows each: S = Q K^T as wgmma
// m64n128k16 with A and B from shared memory, the softmax in registers,
// then O += P V as wgmma with P as the register A operand (the S
// accumulator layout is the A fragment layout) and V from shared memory.
// A consumer issues P V of tile j-1 and Q K^T of tile j as one wgmma block
// (P V waited for before Q K^T is issued, so P and S are never live
// together), and the two consumers take turns (named barriers): one's block
// runs on the tensor cores while the other computes its softmax, whose exp2
// costs about as much as the block's products at these head dims.
//
// Shared memory. A head row is split into two boxes: columns 0..63 (128
// bytes, 128-byte swizzle) and columns 64..kD-1 (another 128-byte box at
// head dim 128; at 80 a 32-byte box, 32-byte swizzle). The tensor map's
// column extent is the true head dim, so columns 72..79 of a 72-wide head
// are out of bounds and arrive as zeros: the zero pad to 80 costs nothing.
// Row extents are the true lengths too (Sq and kv_len; group and
// group_valid), so ragged tiles are zero-filled by the copy engine; scores
// of keys past the limit are still masked to -1e30 in registers. QK^T runs
// kD/16 k16 steps (4 on the first box, 4 or 1 on the second); PV an n64
// wgmma on the first box and an n64 or n16 one on the second (K-major
// descriptors for Q and K, MN-major for V).
//
// Row max over long groups: K is streamed through the ring twice (pass 1
// K only, pass 2 K and V). A whole 1,024-key group of K (160 KB at width
// 80) would fit in shared memory beside Q but a 2,048-key one (320 KB)
// would not, and the second read of K comes from L2 (one head's K of a
// group is at most a few hundred KB), so one code path serves every group.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace hopper {

using mc::bf16;
using mc::kNegInf;
using mc::pack_bf16;
using mc::quad_max;
using mc::quad_sum;

// the numbering of the C entry points' `mode`
enum Mode { kRunning = 0, kFixed = 1, kAux = 2, kRowMax = 3 };

constexpr int kBlockM = 128;          // query rows per block: 2 consumers x 64
constexpr int kBlockN = 128;          // keys per tile
constexpr int kThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMapWords = 16;         // one tensor map's geometry from Python

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A
// wait that outlasts about 2^35 cycles (tens of seconds; a tile takes
// microseconds) traps, so a broken pipeline fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) asm volatile("trap;");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128 B, 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64] (+)= A[64x16] B[16x128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A[64x16] B[16x64], A from registers, B from shared memory
// (MN-major: the N index is contiguous)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[8] += A[64x16] B[16x16], A from registers, B from shared memory
// (MN-major: the N index is contiguous)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the body -------------------------------------------------------------

// Six tensor maps: q, k and v, each as its two column boxes.
struct Maps {
  CUtensorMap q[2], k[2], v[2];
};

struct Args {
  bf16* o;                 // flash: through o_b/o_h/o_t; grouped: [groups*group, H*72]
  float* m_out;            // kAux: [B, H, Sq], natural base
  float* l_out;            // kAux: [B, H, Sq]
  long long o_b, o_h, o_t; // flash: o's element strides
  int H;
  int Sq;                  // queries per (batch, head), or the group size
  int kv_len;              // keys, or group_valid
  int gpb;                 // grouped: groups per batch row
  float q_scale;           // multiplies q before QK^T (kAux: the f32 scores after it)
  float m_const;           // kFixed
};

// Shared-memory layout of one instantiation; every box starts 1,024-aligned.
template <int kD>
struct Layout {
  static constexpr int kW1 = kD - 64;                        // second box's width
  static constexpr int kSw1 = kW1 == 64 ? 128 : 32;          // its swizzle, bytes
  static constexpr int kBox0 = kBlockN * 128;                // bytes of a 128-row box
  static constexpr int kBox1 = kBlockN * kW1 * 2;
  static constexpr int kTile = kBox0 + kBox1;                // Q, K or V tile
  static constexpr int kStages = kD == 128 ? 3 : 4;
  static constexpr int kStage = 2 * kTile;                   // K, then V
  static constexpr int kBars = kTile + kStages * kStage;     // after Q and the ring
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

// The descriptor d advanced by `units` x 16 bytes. A volatile add, so each
// lands right before its wgmma: hoisted together, a block's 24 descriptors
// would hold 48 registers across it.
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t units) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(r) : "l"(d), "l"((uint64_t)units));
  return r;
}

// S = Q K^T for one consumer's 64 query rows (q0, q1: its rows of the two
// column boxes) and the 128 keys of a K tile at k: kD/16 k16 steps, 4 on
// the first box (128-byte swizzle, +32 bytes a step) and the rest on the
// second. The first step overwrites S.
template <int kD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q0, uint32_t q1,
                                         uint32_t k) {
  using L = Layout<kD>;
  const uint64_t dq0 = smem_desc(q0, 16, 8 * 128, 128);
  const uint64_t dk0 = smem_desc(k, 16, 8 * 128, 128);
  const uint64_t dq1 = smem_desc(q1, 16, 8 * L::kW1 * 2, L::kSw1);
  const uint64_t dk1 = smem_desc(k + L::kBox0, 16, 8 * L::kW1 * 2, L::kSw1);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    if (kk < 4)
      wgmma_ss_n128(sc, desc_add(dq0, 2 * kk), desc_add(dk0, 2 * kk), kk > 0);
    else
      wgmma_ss_n128(sc, desc_add(dq1, 2 * (kk - 4)), desc_add(dk1, 2 * (kk - 4)), 1);
  }
}

// O += P V over the 128 keys of a V tile at v: per k16 step an n64 wgmma on
// the first column box and an n64 (head dim 128) or n16 (80) one on the
// second, B MN-major (8 keys of a box apart by 8 rows).
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o0)[32], float (&o1)[Layout<kD>::kW1 / 2],
                                         const uint32_t (&pa)[kBlockN / 16][4], uint32_t v) {
  using L = Layout<kD>;
  const uint64_t dv0 = smem_desc(v, 16, 8 * 128, 128);
  const uint64_t dv1 = smem_desc(v + L::kBox0, 16, 8 * L::kW1 * 2, L::kSw1);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_rs_n64(o0, pa[kk], desc_add(dv0, kk * 16 * 128 / 16));
    if constexpr (L::kW1 == 64)
      wgmma_rs_n64(o1, pa[kk], desc_add(dv1, kk * 16 * 128 / 16));
    else
      wgmma_rs_n16(o1, pa[kk], desc_add(dv1, kk * 16 * 32 / 16));
  }
}

// kGrouped: the grouped geometry (5-D maps, grid (query tile, group,
// head), o [groups * group, H*72]) of K5r, K4 and K5; otherwise the flash
// geometry (4-D maps, grid (query tile, batch * H), o through strides).
template <int kD, int kMode, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 1)
hopper_attention_kernel(const __grid_constant__ Maps maps, const Args a) {
  using L = Layout<kD>;
  constexpr int kPasses = kMode == kRowMax ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_tile = smem;
  unsigned char* ring = smem + L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;

  // flash: x = query tile, y = batch * H + head; grouped: x = query tile of
  // the group, y = group, z = head
  const int q0 = blockIdx.x * kBlockM;
  const int h = kGrouped ? blockIdx.z : blockIdx.y % a.H;
  const int b = kGrouped ? 0 : blockIdx.y / a.H;
  const int grp = kGrouped ? blockIdx.y : 0;
  const int n_tiles = (a.kv_len + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      auto load = [&](const CUtensorMap* m, void* dst, uint64_t* bar, int col, int row) {
        if (kGrouped)
          tma_load_5d(dst, m, bar, col, h, row, grp % a.gpb, grp / a.gpb);
        else
          tma_load_4d(dst, m, bar, col, row, h, b);
      };
      mbar_expect_tx(q_full, L::kTile);
      load(&maps.q[0], q_tile, q_full, 0, q0);
      load(&maps.q[1], q_tile + L::kBox0, q_full, 64, q0);
      int s = 0, phase = 0;
      for (int pass = 0; pass < kPasses; ++pass) {
        const bool with_v = pass == kPasses - 1;
        for (int j = 0; j < n_tiles; ++j) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = ring + s * L::kStage;
          mbar_expect_tx(&full[s], with_v ? 2 * L::kTile : L::kTile);
          load(&maps.k[0], st, &full[s], 0, j * kBlockN);
          load(&maps.k[1], st + L::kBox0, &full[s], 64, j * kBlockN);
          if (with_v) {
            load(&maps.v[0], st + L::kTile, &full[s], 0, j * kBlockN);
            load(&maps.v[1], st + L::kTile + L::kBox0, &full[s], 64, j * kBlockN);
          }
          if (++s == L::kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;                  // this consumer's 64 rows: 64c..64c+63
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;

    mbar_wait(q_full, 0);
    if (kMode != kAux && a.q_scale != 1.f) {
      // q * q_scale in f32, rounded to bf16, in place (an elementwise map:
      // the swizzle does not matter); then made visible to wgmma. K1q's q
      // comes scaled (q_scale 1) and is used as it is.
      auto scale_rows = [&](unsigned char* box, int row_bytes) {
        uint4* p = reinterpret_cast<uint4*>(box + c * 64 * row_bytes);
        for (int i = ct; i < 64 * row_bytes / 16; i += 128) {
          uint4 v = p[i];
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            e[k] = __float2bfloat16(__bfloat162float(e[k]) * a.q_scale);
          p[i] = v;
        }
      };
      scale_rows(q_tile, 128);
      scale_rows(q_tile + L::kBox0, L::kW1 * 2);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + c, 128);
    }
    const uint32_t q_base0 = smem_addr(q_tile) + c * 64 * 128;
    const uint32_t q_base1 = smem_addr(q_tile + L::kBox0) + c * 64 * L::kW1 * 2;
    const uint32_t ring_base = smem_addr(ring);

    float o0[32], o1[L::kW1 / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kW1 / 2; ++i) o1[i] = 0.f;
    float m_row[2] = {kMode == kFixed ? a.m_const : kNegInf,
                      kMode == kFixed ? a.m_const : kNegInf};
    float l_row[2] = {0.f, 0.f};

    // Each wgmma block issues O += P V of the previous tile, waits for it,
    // then issues S = Q K^T of this one; the consumers take turns through
    // two named barriers (ids 3 and 4, 256 threads), so one's block runs on
    // the tensor cores while the other computes its softmax. Waiting for
    // P V before Q K^T keeps P and S from being live at once: the body fits
    // in 168 registers a thread (ptxas allocates no more to the consumers
    // whatever setmaxnreg grants, and serialises the wgmmas past that).
    // Blocks per consumer: one per tile and pass, and the last tile's P V
    // alone. Each call site of `block` is straight-line code: ptxas also
    // serialises wgmma issued on a divergent path.
    const int n_blocks = kPasses * n_tiles + 1;
    int blk = 0;
    if (c == 1) bar_arrive(3, 256);                 // consumer 0 issues first
    float sc[64];
    uint32_t pa[kBlockN / 16][4];   // bf16 P of the previous tile, the A operand
    // with_pv / with_qk: std::integral_constant; pv_done runs once P V is
    // complete (the stage it read is released there)
    auto block = [&](auto with_pv, auto with_qk, int qk_stage, int pv_stage,
                     auto pv_done) {
      bar_sync(3 + c, 256);
      if constexpr (decltype(with_pv)::value) {
        fence_regs(o0);
        fence_regs(o1);
        wgmma_fence();
        issue_pv<kD>(o0, o1, pa, ring_base + pv_stage * L::kStage + L::kTile);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o0);
        fence_regs(o1);
        pv_done();
      }
      if constexpr (decltype(with_qk)::value) {
        fence_regs(sc);
        wgmma_fence();
        issue_qk<kD>(sc, q_base0, q_base1, ring_base + qk_stage * L::kStage);
        wgmma_commit();
      }
      if (c == 0 || blk != n_blocks - 1) bar_arrive(3 + (c ^ 1), 256);
      ++blk;
      if constexpr (decltype(with_qk)::value) {
        wgmma_wait0();
        fence_regs(sc);
      }
    };
    int stage = 0, phase = 0;       // the ring position of the next tile
    auto next_tile = [&] {
      const int s = stage;
      mbar_wait(&full[s], phase);
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
      return s;
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    // scores of key tile j: scaled (kAux), keys at or past kv_len masked
    auto finish_scores = [&](int j) {
      const int k0 = j * kBlockN;
      if (kMode == kAux) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= a.q_scale;
      }
      if (k0 + kBlockN > a.kv_len) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= a.kv_len) sc[i] = kNegInf;
      }
    };
    // p from the scores, l += p, and P packed as the next P V's A operand
    auto softmax = [&] {
      if (kMode == kRunning || kMode == kAux) {
        // o holds P V up to the previous tile: rescale it to the new max
        float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          const float alpha = exp2f(m_row[r] - mx[r]);
          m_row[r] = mx[r];
          l_row[r] *= alpha;
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (((i >> 1) & 1) == r) o0[i] *= alpha;
#pragma unroll
          for (int i = 0; i < L::kW1 / 2; ++i)
            if (((i >> 1) & 1) == r) o1[i] *= alpha;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float p = exp2f(sc[i] - m_row[(i >> 1) & 1]);
          sc[i] = p;
          l_row[(i >> 1) & 1] += p;
        }
      } else {
        // kFixed (the constant m) and kRowMax (each row's true max)
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float m = m_row[(i >> 1) & 1];
          const float p = exp2f(fminf(sc[i], m + 126.f) - m);
          sc[i] = p;
          l_row[(i >> 1) & 1] += p;
        }
      }
      // k-step kk of P V covers keys 16kk..16kk+15, whose scores are
      // sc[8kk..8kk+7] in the A fragment order
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };
    const std::true_type yes;
    const std::false_type no;

    auto nothing = [] {};
    if constexpr (kMode == kRowMax) {
      // pass 1: each row's max over the valid keys
      for (int j = 0; j < n_tiles; ++j) {
        const int s = next_tile();
        block(no, yes, s, 0, nothing);
        finish_scores(j);
#pragma unroll
        for (int i = 0; i < 64; ++i) m_row[(i >> 1) & 1] = fmaxf(m_row[(i >> 1) & 1], sc[i]);
        release(s);
      }
      m_row[0] = quad_max(m_row[0]);
      m_row[1] = quad_max(m_row[1]);
    }
    int prev = next_tile();
    block(no, yes, prev, 0, nothing);
    finish_scores(0);
    softmax();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = next_tile();
      block(yes, yes, s, prev, [&] { release(prev); });
      finish_scores(j);
      softmax();
      prev = s;
    }
    block(yes, no, 0, prev, [&] { release(prev); });

    // o = acc / l, rounded to bf16; rows past the query count are not
    // stored, nor columns past a 72-wide head (the next head's at 80)
    const float l0 = quad_sum(l_row[0]), l1 = quad_sum(l_row[1]);
    const int row0 = q0 + c * 64 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.Sq) continue;
      const float l = r ? l1 : l0;
      bf16* dst;
      if (kGrouped)
        dst = a.o + ((long long)grp * a.Sq + row) * (a.H * 72) + h * 72;
      else
        dst = a.o + b * a.o_b + h * a.o_h + (long long)row * a.o_t;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == r && (i & 1) == 0)
          *reinterpret_cast<uint32_t*>(dst + 8 * (i >> 2) + 2 * t) =
              pack_bf16(o0[i] / l, o0[i + 1] / l);
#pragma unroll
      for (int i = 0; i < L::kW1 / 2; ++i) {
        const int col = 64 + 8 * (i >> 2) + 2 * t;
        if (((i >> 1) & 1) == r && (i & 1) == 0 && col < (kD == 80 ? 72 : kD))
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(o1[i] / l, o1[i + 1] / l);
      }
      if (kMode == kAux && t == 0) {
        const size_t idx = (size_t)blockIdx.y * a.Sq + row;
        a.m_out[idx] = m_row[r] / kLog2e;
        a.l_out[idx] = l;
      }
    }
  }
}

// ---- cross-attention over a short context (K6's attention stage) ------------
//
// The row max of kRowMax with kAux's scaling: q is not pre-scaled, the f32
// scores are multiplied by q_scale = scale * log2(e) after the product, and
// each row's true max over the valid keys is taken before any exp2. Head
// dim 72 carried as 80 (the boxes of Layout<80>). A block keeps one (batch,
// head)'s whole K and V resident (at most kCrossKeyTiles tiles of 128 keys,
// read once) and walks `tiles_per_block` query tiles of it through a
// two-stage Q ring, so the block prologue is paid once per block and not
// once per 128 query rows. 288 threads: consumer warpgroups 0 and 1 (64
// query rows each), then one producer warp; without setmaxnreg each thread
// may hold up to 224 registers.
constexpr int kCrossKeyTiles = 4;     // keys <= 512
constexpr int kCrossThreads = 288;

struct CrossArgs {
  bf16* o;                // [B, N, H*72]
  int H, N, kv_valid;
  int tiles_per_block;    // query tiles of 128 rows a block walks
  float q_scale;          // multiplies the f32 scores
};

struct CrossLayout {
  using L = Layout<80>;
  static constexpr int kKV = 2 * kCrossKeyTiles * L::kTile;   // K tiles, then V tiles
  static constexpr int kQ = 2 * L::kTile;                     // the Q ring
  static constexpr int kBars = kKV + kQ;
  static constexpr int kBytes = kBars + 5 * 8 + 1024;
};

template <int kD>
__global__ void __launch_bounds__(kCrossThreads, 1)
hopper_cross_kernel(const __grid_constant__ Maps maps, const CrossArgs a) {
  static_assert(kD == 80, "head dim 72 carried as 80");
  using L = Layout<kD>;
  using C = CrossLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_ring = smem + C::kKV;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + 2;

  const int h = blockIdx.y % a.H, b = blockIdx.y / a.H;
  const int n_qt = (a.N + kBlockM - 1) / kBlockM;
  const int t0 = blockIdx.x * a.tiles_per_block;
  const int t1 = min(n_qt, t0 + a.tiles_per_block);
  const int n_kt = (a.kv_valid + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: the whole K and V once, then the query tiles ----
    if (lane == 0) {
      auto load = [&](const CUtensorMap* m, unsigned char* dst, uint64_t* bar, int row) {
        tma_load_4d(dst, &m[0], bar, 0, h, row, b);
        tma_load_4d(dst + L::kBox0, &m[1], bar, 64, h, row, b);
      };
      mbar_expect_tx(kv_full, 2 * n_kt * L::kTile);
      for (int j = 0; j < n_kt; ++j) {
        load(maps.k, smem + j * L::kTile, kv_full, j * kBlockN);
        load(maps.v, smem + (kCrossKeyTiles + j) * L::kTile, kv_full, j * kBlockN);
      }
      for (int qt = t0, i = 0; qt < t1; ++qt, ++i) {
        const int s = i & 1;
        mbar_wait(&q_empty[s], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[s], L::kTile);
        load(maps.q, q_ring + s * L::kTile, &q_full[s], qt * kBlockM);
      }
    }
    return;
  }

  // ---- consumers ----
  const int c = warp / 4;                     // rows 64c..64c+63 of a query tile
  const int g = lane >> 2, t = lane & 3;
  const uint32_t kv_base = smem_addr(smem);
  float sc[64], o0[32], o1[8];
  uint32_t pa[kBlockN / 16][4];
  mbar_wait(kv_full, 0);

  // S = Q K^T of key tile j, scaled, keys at or past kv_valid masked
  auto scores = [&](uint32_t q0, uint32_t q1, int j) {
    fence_regs(sc);
    wgmma_fence();
    issue_qk<80>(sc, q0, q1, kv_base + j * L::kTile);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= a.q_scale;
    if ((j + 1) * kBlockN > a.kv_valid) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (j * kBlockN + 8 * (i >> 2) + 2 * t + (i & 1) >= a.kv_valid) sc[i] = kNegInf;
    }
  };

  for (int qt = t0, i = 0; qt < t1; ++qt, ++i) {
    const int s = i & 1;
    mbar_wait(&q_full[s], (i >> 1) & 1);
    const uint32_t q0 = smem_addr(q_ring + s * L::kTile) + c * 64 * 128;
    const uint32_t q1 = smem_addr(q_ring + s * L::kTile + L::kBox0) + c * 64 * L::kW1 * 2;

    // pass 1: each row's max over the valid keys
    float m_row[2] = {kNegInf, kNegInf};
    for (int j = 0; j < n_kt; ++j) {
      scores(q0, q1, j);
#pragma unroll
      for (int e = 0; e < 64; ++e) m_row[(e >> 1) & 1] = fmaxf(m_row[(e >> 1) & 1], sc[e]);
    }
    m_row[0] = quad_max(m_row[0]);
    m_row[1] = quad_max(m_row[1]);

    // pass 2: p = exp2(s - max), l sums the f32 p, O += bf16(P) V
#pragma unroll
    for (int e = 0; e < 32; ++e) o0[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o1[e] = 0.f;
    float l_row[2] = {0.f, 0.f};
    for (int j = 0; j < n_kt; ++j) {
      scores(q0, q1, j);
      if (j == n_kt - 1) {            // the Q stage is read for the last time
        __syncwarp();
        if (lane == 0) mbar_arrive(&q_empty[s]);
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const float p = exp2f(sc[e] - m_row[(e >> 1) & 1]);
        sc[e] = p;
        l_row[(e >> 1) & 1] += p;
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      fence_regs(o0);
      fence_regs(o1);
      wgmma_fence();
      issue_pv<80>(o0, o1, pa, kv_base + (kCrossKeyTiles + j) * L::kTile);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o0);
      fence_regs(o1);
    }

    // o = acc / l, rounded to bf16; rows past N are not stored
    const float l0 = quad_sum(l_row[0]), l1 = quad_sum(l_row[1]);
    const int row0 = qt * kBlockM + c * 64 + (warp % 4) * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.N) continue;
      const float l = r ? l1 : l0;
      bf16* dst = a.o + ((size_t)b * a.N + row) * (a.H * 72) + h * 72;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (((e >> 1) & 1) == r && (e & 1) == 0)
          *reinterpret_cast<uint32_t*>(dst + 8 * (e >> 2) + 2 * t) =
              pack_bf16(o0[e] / l, o0[e + 1] / l);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = 64 + 8 * (e >> 2) + 2 * t;
        if (((e >> 1) & 1) == r && (e & 1) == 0 && col < 72)
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(o1[e] / l, o1[e + 1] / l);
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: its address comes from the
// runtime (cudaGetDriverEntryPoint), so the library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// One map from its geometry words (ops/attention.py, tma_map): rank,
// swizzle bytes (128, 32 or 0: none), 5 extents, 4 byte strides, 5 box
// extents, innermost first.
inline int encode_map(CUtensorMap* map, const void* base, const long long* w) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int rank = (int)w[0];
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], one[5];
  for (int i = 0; i < 5; ++i) {
    dims[i] = (cuuint64_t)w[2 + i];
    box[i] = (cuuint32_t)w[11 + i];
    one[i] = 1;
  }
  for (int i = 0; i < 4; ++i) strides[i] = (cuuint64_t)w[7 + i];
  const CUtensorMapSwizzle swizzle = w[1] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : w[1] == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Encodes the six maps (q, k, v x two boxes; `words`: 6 x kMapWords) and
// launches the instantiation on `grid`.
template <int kD, int kMode, bool kGrouped = false>
int launch(const void* q, const void* k, const void* v, const long long* words,
           const Args& a, dim3 grid, cudaStream_t stream) {
  Maps maps;
  const void* base[3] = {q, k, v};
  CUtensorMap* dst[6] = {&maps.q[0], &maps.q[1], &maps.k[0], &maps.k[1], &maps.v[0],
                         &maps.v[1]};
  for (int i = 0; i < 6; ++i) {
    const int err = encode_map(dst[i], base[i / 2], words + i * kMapWords);
    if (err) return err;
  }
  auto kernel = hopper_attention_kernel<kD, kMode, kGrouped>;
  const int bytes = Layout<kD>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// The six maps of hopper_cross_kernel, then its launch: `blocks` blocks per
// (batch, head), B * H of them.
inline int launch_cross(const void* q, const void* k, const void* v, const long long* words,
                        const CrossArgs& a, int blocks, int BH, cudaStream_t stream) {
  Maps maps;
  const void* base[3] = {q, k, v};
  CUtensorMap* dst[6] = {&maps.q[0], &maps.q[1], &maps.k[0], &maps.k[1], &maps.v[0],
                         &maps.v[1]};
  for (int i = 0; i < 6; ++i) {
    const int err = encode_map(dst[i], base[i / 2], words + i * kMapWords);
    if (err) return err;
  }
  const int bytes = CrossLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      hopper_cross_kernel<80>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  hopper_cross_kernel<80><<<dim3(blocks, BH), kCrossThreads, bytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace hopper
