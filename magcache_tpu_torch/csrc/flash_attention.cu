// K1, K1b and K1c: flash attention forward, bf16, head dim 128, one kernel
// body that reads q, k, v and writes o through (batch, head, token) strides.
//
// K1 replaces the TPU kernel magcache_tpu/ops/attention.py:flash_attention_bshd
// (Pallas bodies _flash_kernel_bshd_fixed_max and _flash_kernel_bshd) on the
// DiT activation layout [B, S, H, D]. K1b replaces flash_attention_bhsd
// (_flash_kernel, _flash_kernel_fixed_max) on [B, H, S, D]: the same math,
// only the strides differ, so a [B, S, H, D] tensor viewed as [B, H, S, D]
// needs no transpose copy (Ulysses attention after its all-to-all). K1c
// replaces flash_attention_bhsd_aux (_flash_kernel_aux): the running-max
// softmax that also returns each row's max m and sum l (f32 [B, H, Sq]), the
// state that ring attention merges across key shards.
//
// Math, point for point as the TPU kernel rounds it:
//   - q is pre-scaled by scale*log2(e) and rounded to bf16 before the score
//     product (the scale itself is rounded to bf16 by the caller);
//   - s = q.k in f32 (tensor-core accumulation), keys at or past kv_len are
//     masked to -1e30, and K/V rows past kv_len are zero-filled on load so a
//     ragged tail can never feed 0*NaN into the accumulator;
//   - base-2 softmax. Static-shift variant (kFixedMax, the one Wan runs):
//     p = exp2(min(s, m + 126) - m) with the constant m = fixed_max, no
//     running max and no rescale. Running-max variant: the usual online
//     softmax with alpha = exp2(m_old - m_new);
//   - p is rounded to bf16 before the PV product, l sums the f32 p, the f32
//     accumulator is divided by l at the end and rounded to bf16.
// K1c (kAux) rounds at other points, as its TPU kernel does: q is NOT
// pre-scaled; the f32 scores are multiplied by scale*log2(e) after the
// product; keys at or past kv_len are always masked; from there the running
// max as above. m is stored in the natural base (the base-2 running max
// divided by log2(e)), l is base-invariant.
//
// What bounds it on the H100: at Wan-480p self-attention (B=2, S=32,760,
// H=12, D=128) the kernel does 4*B*H*S^2*D = 1.3e13 flops over 0.2 GB of
// q/k/v, about 66,000 flops per byte, far above the card's ~295 flops/byte
// ridge: it is bound by tensor-core issue, and by how well the loads of the
// next K/V tile hide under the current tile's math. Cross-attention (512
// keys) is smaller but still compute-bound.
//
// What the design does about that: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); the Q fragments stay in
// registers for the whole KV loop, and S and P never leave registers (the
// m16n8 accumulator layout of S is exactly the A-operand layout of P for the
// PV product, so P is repacked in place). K is read from shared memory with
// conflict-free 32-bit loads (rows padded by 16 bytes) and V through
// ldmatrix.trans. One block is 4 warps x 16 query rows; the KV loop runs
// inside the block, since Hopper blocks carry no scratch across grid steps
// the way the TPU's sequential grid does. Loads are synchronous and there is
// no wgmma/TMA pipeline yet: overlap comes only from the 3-4 blocks resident
// on each SM. That is the first thing a later change should add.
//
// K1q, the qk-normed variant (flash_attention_qknorm_kernel below): the
// TPU kernel's norm=(true_d, eps) branch, which STDiT3 runs on frames of
// more than 2,048 tokens (720p). Head dim 72, fixed max only (its callers
// all pass fixed_max; the RMS-normed scores are bounded). Rounding points:
//   - q and k: f32 sum of squares over the 72 values / true_d, times
//     rsqrt(var + eps), times the f32 gain [H, 72] (as _rms_head);
//   - q is then multiplied by scale*log2(e) in f32 and rounded to bf16 once;
//     k is rounded to bf16 (unlike K1 above, whose q is scaled in bf16);
//   - from there as K1's fixed-max variant.
// q, k and v are read in place with their own batch and token strides (the
// column slices of STDiT3's [rows*T, S, 3*H*72] qkv projection); a head row
// is 144 contiguous, 16-byte aligned bytes. 72 is padded to 80 only in
// shared memory (five k16 steps for QK^T; the PV product's tenth n8 tile
// holds the zero pad columns and is not stored), as K5 does (mma_tile.cuh).
// A block takes 64 queries of one (batch, head) and loops over the keys in
// tiles of 64; two adjacent threads load and normalise each row. k is
// normalised again every time a block loads a K tile: at 720p each key row
// is normalised by all 57 query blocks of its head, about 300 f32
// operations per key row and block against the tile's 1.3 MFLOP of mma
// work, which is about a fifth more time than the tensor cores need at
// their peak; K and V are re-read 57 times, mostly from L2 (one head's K
// and V are 1 MB).
//
// What bounds K1q: at 720p one call is 4 x 30 x 16 x 3,600^2 x 72 = 1.79
// TFLOP over 1.0 GB of q/k/v/o: compute bound, 1.81 ms at 989 TFLOP/s.
//
// Plain C interface, loaded from Python with ctypes; the wrapper checks
// shapes, dtypes, strides and alignment, allocates the output and passes
// pointers and PyTorch's current stream. The launch returns
// cudaGetLastError().

#include "mma_tile.cuh"

namespace {

using mc::bf16;
using mc::ldmatrix_x4_trans;
using mc::mma_16816;
using mc::pack_bf16;

constexpr int kHeadDim = 128;
constexpr int kBlockM = 64;                 // query rows per block, 16 per warp
constexpr int kBlockN = 64;                 // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kHeadDim + 8;       // padded smem row, bf16 elements
constexpr int kChunksPerRow = kHeadDim / 8; // 16-byte chunks per row
using mc::kNegInf;
constexpr size_t kSmemBytes =
    (size_t)(kBlockM + 2 * kBlockN) * kStride * sizeof(__nv_bfloat16);

// Copy the kBlockN rows of one head that start at src into a padded smem
// tile. Rows at or past `limit` are zero-filled.
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long row_stride, int limit) {
  for (int c = threadIdx.x; c < kBlockN * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * kStride + col) = val;
  }
}

enum Mode { kRunning = 0, kFixedMax = 1, kAux = 2 };
constexpr float kLog2e = 1.4426950408889634f;

// One tensor's element strides: batch, head, token (the channel stride is 1).
struct Strides {
  long long b, h, t;
};

struct FlashArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* m_out;            // kAux only: [B, H, Sq], natural base
  float* l_out;            // kAux only: [B, H, Sq]
  Strides qs, ks, vs, os;
  int Sq, H, kv_len;
  float q_scale;           // scale*log2(e): applied to q (bf16) or, kAux, to s (f32)
  float m_const;           // kFixedMax only
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBlockM * kStride;
  __nv_bfloat16* Vs = Ks + kBlockN * kStride;

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * kBlockM;
  const int Sq = a.Sq, kv_len = a.kv_len;
  const __nv_bfloat16* qh = a.q + b * a.qs.b + h * a.qs.h;
  const __nv_bfloat16* kh = a.k + b * a.ks.b + h * a.ks.h;
  const __nv_bfloat16* vh = a.v + b * a.vs.b + h * a.vs.h;
  __nv_bfloat16* oh = a.o + b * a.os.b + h * a.os.h;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;     // mma group: accumulator rows g and g + 8
  const int t = lane & 3;      // thread in group: accumulator cols 2t, 2t + 1
  const int wr = warp * 16;    // this warp's first row in the Q tile

  // Q tile, scaled by scale*log2(e) and rounded to bf16 (kAux: as it is);
  // rows past Sq are 0.
  for (int c = threadIdx.x; c < kBlockM * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) {
      val = *reinterpret_cast<const uint4*>(qh + (long long)(q0 + r) * a.qs.t + col);
      if (kMode != kAux) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = __float2bfloat16(__bfloat162float(e[i]) * a.q_scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * kStride + col) = val;
  }
  __syncthreads();

  // A fragments of this warp's 16 x 128 Q rows, kept for the whole KV loop.
  uint32_t qf[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const __nv_bfloat16* base = Qs + (wr + g) * kStride + kk * 16 + t * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};   // running max (unused when fixed)
  float l_run[2] = {0.f, 0.f};           // this thread's partial row sums

  const int n_tiles = (kv_len + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    // the tile's base is advanced here, once per tile: with the row offset
    // folded into every thread's address instead, nvcc 12.8 schedules the
    // fixed-max loop about 5% slower at Wan's self shape (PERF.md)
    load_kv_tile(Ks, kh + (long long)k0 * a.ks.t, a.ks.t, kv_len - k0);
    load_kv_tile(Vs, vh + (long long)k0 * a.vs.t, a.vs.t, kv_len - k0);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const __nv_bfloat16* kb = Ks + (nt * 8 + g) * kStride + kk * 16 + t * 2;
        mma_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                  *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }
    if (kMode == kAux) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= a.q_scale;
    }
    if (k0 + kBlockN > kv_len) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + t * 2 + (e & 1) >= kv_len) s[nt][e] = kNegInf;
    }

    if (kMode == kFixedMax) {
      const float m_const = a.m_const;
      const float cap = m_const + 126.f;   // exp2 overflow guard
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fminf(s[nt][e], cap) - m_const);
          s[nt][e] = p;
          l_run[e >> 1] += p;
        }
    } else {
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = exp2f(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < kHeadDim / 8; ++nt) {
          acc[nt][2 * r] *= alpha;
          acc[nt][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - m_run[e >> 1]);
          s[nt][e] = p;
          l_run[e >> 1] += p;
        }
    }

    // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are the A fragment
    // of keys 16kk..16kk+15; V's B fragments come from ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow =
          Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < kHeadDim / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + np * 16);
        mma_16816(acc[2 * np], a, bv[0], bv[1]);
        mma_16816(acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
    const int col = nt * 8 + t * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (long long)r0 * a.os.t + col) =
          pack_bf16(acc[nt][0] / l_run[0], acc[nt][1] / l_run[0]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (long long)r1 * a.os.t + col) =
          pack_bf16(acc[nt][2] / l_run[1], acc[nt][3] / l_run[1]);
  }
  if (kMode == kAux && t == 0) {
    // the quad holds the same m and l; m goes back to the natural base
    const size_t row = (size_t)blockIdx.y * Sq;
    if (r0 < Sq) {
      a.m_out[row + r0] = m_run[0] / kLog2e;
      a.l_out[row + r0] = l_run[0];
    }
    if (r1 < Sq) {
      a.m_out[row + r1] = m_run[1] / kLog2e;
      a.l_out[row + r1] = l_run[1];
    }
  }
}

template <int kMode>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBlockM - 1) / kBlockM, B * a.H);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_mode(int mode, const FlashArgs& a, int B, cudaStream_t stream) {
  if (mode == kFixedMax) return launch<kFixedMax>(a, B, stream);
  if (mode == kAux) return launch<kAux>(a, B, stream);
  return launch<kRunning>(a, B, stream);
}

// ---- K1q: per-head RMS qk-norm fused into the q/k loads, head dim 72 -------

constexpr int kQD = mc::kHD;       // 72
constexpr int kQDP = mc::kHDP;     // 80 in shared memory
constexpr int kQStr = mc::kHStr;   // 88-element smem rows
constexpr int kQTile = 64;         // queries per block, keys per KV tile

struct QkNormArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;                         // [B, Sq, H, 72], contiguous
  const float* qg;                 // [H, 72]
  const float* kg;
  long long q_bs, q_ts, k_bs, k_ts, v_bs, v_ts;   // batch, token strides
  int Sq, H, kv_len;
  float q_scale, inv_true_d, eps, m_const;
};

__global__ void __launch_bounds__(kThreads)
flash_attention_qknorm_kernel(QkNormArgs p) {
  __shared__ __align__(16) bf16 Qs[kQTile * kQStr];
  __shared__ __align__(16) bf16 Ks[kQTile * kQStr];
  __shared__ __align__(16) bf16 Vs[kQTile * kQStr];
  __shared__ float gains[2][kQD];                   // q and k gains of head h
  const int q0 = blockIdx.x * kQTile;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int warp = threadIdx.x >> 5;
  const bf16* qh = p.q + b * p.q_bs + h * kQD;
  const bf16* kh = p.k + b * p.k_bs + h * kQD;
  const bf16* vh = p.v + b * p.v_bs + h * kQD;
  for (int i = threadIdx.x; i < 2 * kQD; i += kThreads)
    gains[i / kQD][i % kQD] = (i < kQD ? p.qg : p.kg)[h * kQD + i % kQD];
  __syncthreads();

  // threads 2r and 2r + 1 take row r of every tile; q is normed, scaled by
  // scale*log2(e) in f32 and rounded once
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  mc::load_qk_norm_half(Qs + row * kQStr, qh + (q0 + row) * p.q_ts, q0 + row < p.Sq,
                        gains[0], p.inv_true_d, p.eps, nullptr, nullptr, p.q_scale,
                        half);
  __syncthreads();
  uint32_t qf[kQDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < kQDP / 16; ++kk)
    mc::load_a_frag(qf[kk], Qs + warp * 16 * kQStr + kk * 16, kQStr);

  float acc[kQDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < kQDP / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};
  const int n_tiles = (p.kv_len + kQTile - 1) / kQTile;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kQTile;
    __syncthreads();          // every warp is done with the previous tile
    const int key = k0 + row;
    mc::load_qk_norm_half(Ks + row * kQStr, kh + key * p.k_ts, key < p.kv_len,
                          gains[1], p.inv_true_d, p.eps, nullptr, nullptr, 1.f, half);
    mc::load_head_half(Vs + row * kQStr, vh + key * p.v_ts, key < p.kv_len, half);
    __syncthreads();
    float s[kQTile / 8][4];
    mc::qk_scores<kQTile / 8>(s, qf, Ks);
    mc::fixed_max_softmax_pv<kQTile / 8>(s, l, acc, Vs, k0, p.kv_len, p.m_const);
  }
  const int r0 = q0 + warp * 16;
  mc::store_head_rows(p.o, (size_t)b * p.Sq + r0, min(16, p.Sq - r0), acc, l,
                      (size_t)p.H * kQD, h * kQD);
}

}  // namespace

extern "C" int mc_flash_attention_qknorm(
    const void* q, const void* k, const void* v, void* o, const void* qg,
    const void* kg, int B, int Sq, int H, int kv_len, long long q_bs,
    long long q_ts, long long k_bs, long long k_ts, long long v_bs,
    long long v_ts, float q_scale, float true_d, float eps, float m_const,
    void* stream) {
  QkNormArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.qg = static_cast<const float*>(qg);
  a.kg = static_cast<const float*>(kg);
  a.q_bs = q_bs;
  a.q_ts = q_ts;
  a.k_bs = k_bs;
  a.k_ts = k_ts;
  a.v_bs = v_bs;
  a.v_ts = v_ts;
  a.Sq = Sq;
  a.H = H;
  a.kv_len = kv_len;
  a.q_scale = q_scale;
  a.inv_true_d = 1.f / true_d;
  a.eps = eps;
  a.m_const = m_const;
  const dim3 grid((Sq + kQTile - 1) / kQTile, B * H);
  flash_attention_qknorm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K1: contiguous [B, S, H, 128] q, k, v and o.
extern "C" int mc_flash_attention_bshd(const void* q, const void* k,
                                       const void* v, void* o, int B, int Sq,
                                       int Skv, int H, int kv_len,
                                       float q_scale, int fixed_max,
                                       float m_const, void* stream) {
  FlashArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  const long long row = (long long)H * kHeadDim;
  a.qs = a.os = Strides{(long long)Sq * row, kHeadDim, row};
  a.ks = a.vs = Strides{(long long)Skv * row, kHeadDim, row};
  a.Sq = Sq;
  a.H = H;
  a.kv_len = kv_len;
  a.q_scale = q_scale;
  a.m_const = m_const;
  return launch_mode(fixed_max ? kFixedMax : kRunning, a, B,
                     static_cast<cudaStream_t>(stream));
}

// K1b (mode 0: running max, 1: fixed max) and K1c (mode 2: running max, the
// f32 scores scaled after the product, m and l returned): q, k, v and o of
// head dim 128 read through their (batch, head, token) element strides,
// `strides` = {q, k, v, o} x {batch, head, token}.
extern "C" int mc_flash_attention_strided(
    const void* q, const void* k, const void* v, void* o, void* m_out,
    void* l_out, int B, int Sq, int H, int kv_len, const long long* strides,
    float q_scale, int mode, float m_const, void* stream) {
  if (mode < kRunning || mode > kAux) return (int)cudaErrorInvalidValue;
  FlashArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.qs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.os = Strides{strides[9], strides[10], strides[11]};
  a.Sq = Sq;
  a.H = H;
  a.kv_len = kv_len;
  a.q_scale = q_scale;
  a.m_const = m_const;
  return launch_mode(mode, a, B, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
