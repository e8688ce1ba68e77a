// K1, K1b and K1c: flash attention forward, bf16, head dim 128, one kernel
// body (hopper_attention.cuh, head dim 128) that reads q, k and v through
// TMA tensor maps and writes o through (batch, head, token) strides.
//
// K1 replaces the TPU kernel magcache_tpu/ops/attention.py:flash_attention_bshd
// (Pallas bodies _flash_kernel_bshd_fixed_max and _flash_kernel_bshd) on the
// DiT activation layout [B, S, H, D]. K1b replaces flash_attention_bhsd
// (_flash_kernel, _flash_kernel_fixed_max) on [B, H, S, D]: the same math,
// only the strides differ, so a [B, S, H, D] tensor viewed as [B, H, S, D]
// needs no transpose copy (Ulysses attention after its all-to-all). K1c
// replaces flash_attention_bhsd_aux (_flash_kernel_aux): the running-max
// softmax that also returns each row's max m and sum l (f32 [B, H, Sq]), the
// state that ring attention merges across key shards. K1 is launched as K1b
// on the head-major view of its [B, S, H, D] tensors: one body, one tile
// order, the same bits.
//
// Math, point for point as the TPU kernel rounds it:
//   - q is pre-scaled by scale*log2(e) and rounded to bf16 before the score
//     product (the scale itself is rounded to bf16 by the caller);
//   - s = q.k in f32 (tensor-core accumulation), keys at or past kv_len are
//     masked to -1e30, and K/V rows past kv_len arrive as zeros (the tensor
//     map's token extent is kv_len) so a ragged tail can never feed 0*NaN
//     into the accumulator;
//   - base-2 softmax. Static-shift variant (the one Wan runs):
//     p = exp2(min(s, m + 126) - m) with the constant m = fixed_max, no
//     running max and no rescale. Running-max variant: the usual online
//     softmax with alpha = exp2(m_old - m_new);
//   - p is rounded to bf16 before the PV product, l sums the f32 p, the f32
//     accumulator is divided by l at the end and rounded to bf16.
// K1c rounds at other points, as its TPU kernel does: q is NOT pre-scaled;
// the f32 scores are multiplied by scale*log2(e) after the product; keys at
// or past kv_len are always masked; from there the running max as above. m
// is stored in the natural base (the base-2 running max divided by
// log2(e)), l is base-invariant.
//
// What bounds it on the H100: at Wan-480p self-attention (B=2, S=32,760,
// H=12, D=128) the kernel does 4*B*H*S^2*D = 1.3e13 flops over 0.2 GB of
// q/k/v, about 66,000 flops per byte, far above the card's ~295 flops/byte
// ridge: it is bound by tensor-core issue. The design (hopper_attention.cuh)
// feeds wgmma from TMA-filled shared memory with a producer warp that keeps
// the next K/V tiles in flight, and two consumer warpgroups that take turns
// on the tensor cores, each running its softmax while the other's wgmma run.
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

#include "hopper_attention.cuh"
#include "mma_tile.cuh"

namespace {

using mc::bf16;

constexpr int kThreads = 128;      // K1q: 4 warps x 16 query rows

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

// K1 and K1b (mode 0: running max, 1: fixed max) and K1c (mode 2: running
// max, the f32 scores scaled after the product, m and l returned) on
// [B, H, S, 128] q, k and v described by `maps` (q, k, v x two column
// boxes, ops/attention.py:flash_tma_maps); o is written through its
// (batch, head, token) element strides `o_strides`.
extern "C" int mc_flash_attention_tma(const void* q, const void* k, const void* v,
                                      void* o, void* m_out, void* l_out,
                                      const long long* maps, const long long* o_strides,
                                      int B, int H, int Sq, int kv_len, float q_scale,
                                      int mode, float m_const, void* stream) {
  hopper::Args a{};
  a.o = static_cast<bf16*>(o);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.o_b = o_strides[0];
  a.o_h = o_strides[1];
  a.o_t = o_strides[2];
  a.H = H;
  a.Sq = Sq;
  a.kv_len = kv_len;
  a.q_scale = q_scale;
  a.m_const = m_const;
  const dim3 grid((Sq + hopper::kBlockM - 1) / hopper::kBlockM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case hopper::kRunning:
      return hopper::launch<128, hopper::kRunning>(q, k, v, maps, a, grid, st);
    case hopper::kFixed:
      return hopper::launch<128, hopper::kFixed>(q, k, v, maps, a, grid, st);
    case hopper::kAux:
      return hopper::launch<128, hopper::kAux>(q, k, v, maps, a, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
