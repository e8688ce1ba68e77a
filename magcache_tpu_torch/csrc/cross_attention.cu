// K6: the whole cross-attention module in one kernel, bf16, head dim 72:
//     out = [x +] (softmax(q k^T * scale) v) @ wo^T + bo,  q = x @ wq^T + bq
// over a short context (STDiT3's 300 caption tokens).
//
// Replaces magcache_tpu/ops/attention.py:fused_cross_attention (Pallas body
// _cross_fused_kernel). x is [B, N, dm]; wq [H*72, dm] and wo [d_out, H*72]
// are nn.Linear weights; k and v [B, L, H*72] are the context projections.
//
// Math, point for point as the TPU kernel rounds it:
//   - q = x @ wq^T in f32, + bq, rounded to bf16;
//   - scores in f32, times scale * log2(e); keys at or past kv_valid masked;
//   - row-max softmax p = exp2(s - max), l = sum of the f32 p (the kernel's
//     normaliser branch; the TPU's pad-lane trick exists only for its
//     128-lane padding), p rounded to bf16 before PV, divided by l after;
//   - o rounded to bf16 before the out-projection; f32 accumulate, + bo,
//     + x in f32 when residual; one rounding at the store.
//
// What bounds it on the H100: at STDiT3-XL/2 480p (x 2 x 23,850 x 1152,
// 300 keys) the two 1152 x 1152 projections are 0.25 TFLOP and the
// attention 0.07: tensor-core bound, with q and o (2 x 110 MB) the traffic
// the fusion keeps out of device memory.
//
// What the design does about it: a block of 8 warps owns 64 query rows and
// keeps their q, then their o, in one [64, H*72] bf16 tile of shared memory
// (148 KB at H*72 = 1152). Phase 1 computes q in 256-column chunks, each
// warp 32 rows x 64 columns (x and wq staged global -> registers -> shared
// memory, double buffered); phase 2 runs two heads at a time, four warps
// (16 rows each) per head, over the keys in tiles of 64 read straight from
// the [B, L, H*72] projections (K and V of one head are 300 x 72: streamed,
// since the block's q tile already takes most of shared memory) - a first
// pass finds each row's max, a second accumulates p and PV exactly as the
// TPU's one-shot softmax rounds them - and writes o over that head's q
// columns; phase 3 multiplies the o tile by wo like phase 1. All products
// are mma.sync.m16n8k16 fed by ldmatrix. One block per SM fits; no
// wgmma/TMA.

#include "mma_tile.cuh"

namespace {

using mc::bf16;

constexpr int kBM = 64;
constexpr int kBK = 32;
constexpr int kBN = 256;                  // projection column chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupThreads = kThreads / 2;   // one head per 4-warp group
constexpr int kStage = kBK + 8;           // staged tile row, elements
constexpr int kKeyTile = 64;
constexpr size_t kStageBytes =
    (size_t)2 * (kBM + kBN) * kStage * sizeof(bf16);   // 51,200 B
constexpr int kKeyTileElems = kKeyTile * mc::kHStr;

static_assert((size_t)4 * kKeyTileElems * sizeof(bf16) <= kStageBytes,
              "both groups' K/V key tiles alias the staging buffers");

struct Args {
  const bf16* x;       // [B, N, dm]
  const bf16* wq;      // [hd, dm]
  const float* bq;     // [hd]
  const bf16* k;       // [B, L, hd]
  const bf16* v;
  const bf16* wo;      // [d_out, hd]
  const float* bo;     // [d_out]
  bf16* out;           // [B, N, d_out]
  int N, dm, hd, d_out, H, L, kv_valid, qstr, residual;
  float scale_log2e;
};

// acc = A[64 rows, K] @ W[n0..n0+255, K]^T for this warp's 32 rows
// (32 * (warp & 1)) x 64 columns (64 * (warp >> 1)), with A streamed from
// global (a_src != null) or resident in shared memory.
__device__ __forceinline__ void gemm_chunk(
    float (*acc)[8][4], const bf16* a_src, int a_rows, int a_ld,
    const bf16* a_smem, int a_sstr, const bf16* w, int n0, int nrows, int K,
    bf16* stage) {
  bf16* As[2] = {stage, stage + kBM * kStage};
  bf16* Bs[2] = {stage + 2 * kBM * kStage, stage + 2 * kBM * kStage + kBN * kStage};
  const int warp = threadIdx.x >> 5;
  const int wr = (warp & 1) * 32, wc = (warp >> 1) * 64;
  mc::TileCopy32<kBM, kThreads> acopy;
  mc::TileCopy32<kBN, kThreads> bcopy;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mi][i][0] = acc[mi][i][1] = acc[mi][i][2] = acc[mi][i][3] = 0.f;
  const int nk = (K + kBK - 1) / kBK;
  if (a_src) acopy.load(a_src, 0, a_rows, a_ld, 0, K);
  bcopy.load(w, n0, nrows, K, 0, K);
  if (a_src) acopy.store(As[0], kStage);
  bcopy.store(Bs[0], kStage);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      if (a_src) acopy.load(a_src, 0, a_rows, a_ld, (kt + 1) * kBK, K);
      bcopy.load(w, n0, nrows, K, (kt + 1) * kBK, K);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (a_src)
          mc::load_a_frag(af[mi], As[cur] + (wr + mi * 16) * kStage + kk * 16, kStage);
        else
          mc::load_a_frag(af[mi], a_smem + (wr + mi * 16) * a_sstr + kt * kBK + kk * 16,
                          a_sstr);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        mc::load_b_frag_nk(b, Bs[cur] + (wc + np * 16) * kStage + kk * 16, kStage);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mc::mma_16816(acc[mi][2 * np], af[mi], b[0], b[1]);
          mc::mma_16816(acc[mi][2 * np + 1], af[mi], b[2], b[3]);
        }
      }
    }
    if (kt + 1 < nk) {
      if (a_src) acopy.store(As[cur ^ 1], kStage);
      bcopy.store(Bs[cur ^ 1], kStage);
    }
    __syncthreads();
  }
}

// Key rows key0..key0+63 of head h from src [L, hd] into a [64, 88] tile,
// by the 128 threads of one group; rows at or past L are zeros.
__device__ __forceinline__ void load_key_tile(bf16* dst, const bf16* src,
                                              int key0, int L, int hd, int h) {
  constexpr int kChunks = mc::kHDP / 8;   // 10 per row, the last one zero
  for (int c = threadIdx.x % kGroupThreads; c < kKeyTile * kChunks; c += kGroupThreads) {
    const int r = c / kChunks, j = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < mc::kHD / 8 && key0 + r < L)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(key0 + r) * hd +
                                            h * mc::kHD + j * 8);
    *reinterpret_cast<uint4*>(dst + r * mc::kHStr + j * 8) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* QO = reinterpret_cast<bf16*>(smem);                 // [64, qstr]
  bf16* stage = QO + kBM * p.qstr;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 1) * 32, wc = (warp >> 1) * 64;   // projection tiles
  const int grp = warp >> 2;                 // attention: head parity
  const int ar = (warp & 3) * 16;            // attention: this warp's rows
  bf16* Kt = stage + grp * 2 * kKeyTileElems;               // aliases staging
  bf16* Vt = Kt + kKeyTileElems;
  const bf16* xb = p.x + (size_t)b * p.N * p.dm;
  const int rows = min(kBM, p.N - m0);

  // q/o tile columns past hd are read by the out-projection's last k-step.
  for (int c = threadIdx.x; c < kBM * (p.qstr - p.hd); c += kThreads)
    QO[(c / (p.qstr - p.hd)) * p.qstr + p.hd + c % (p.qstr - p.hd)] = __float2bfloat16(0.f);

  float acc[2][8][4];
  // Phase 1: q = x @ wq^T + bq, rounded to bf16, into QO.
  for (int n0 = 0; n0 < p.hd; n0 += kBN) {
    gemm_chunk(acc, xb + (size_t)m0 * p.dm, rows, p.dm, nullptr, 0, p.wq, n0,
               p.hd, p.dm, stage);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wc + nt * 8 + 2 * t;
        if (n >= p.hd) continue;
        const float b0 = p.bq[n], b1 = p.bq[n + 1];
        bf16* q0 = QO + (wr + mi * 16 + g) * p.qstr + n;
        *reinterpret_cast<uint32_t*>(q0) =
            mc::pack_bf16(acc[mi][nt][0] + b0, acc[mi][nt][1] + b1);
        *reinterpret_cast<uint32_t*>(q0 + 8 * p.qstr) =
            mc::pack_bf16(acc[mi][nt][2] + b0, acc[mi][nt][3] + b1);
      }
  }
  __syncthreads();

  // Phase 2: heads in pairs, group grp taking head 2i + grp; two passes
  // over the key tiles; o overwrites q. (A group reads 8 columns past its
  // head for the last k16 step and zeroes them, so the other group's
  // writes there are never used.)
  const bf16* kb = p.k + (size_t)b * p.L * p.hd;
  const bf16* vb = p.v + (size_t)b * p.L * p.hd;
  const int n_tiles = (min(p.kv_valid, p.L) + kKeyTile - 1) / kKeyTile;
  for (int h0 = 0; h0 < p.H; h0 += 2) {
    const int h = h0 + grp;
    const bool active = h < p.H;     // an odd head count idles group 1 last
    uint32_t qf[mc::kHDP / 16][4];
    if (active) {
#pragma unroll
      for (int kk = 0; kk < mc::kHDP / 16; ++kk)
        mc::load_a_frag(qf[kk], QO + ar * p.qstr + h * mc::kHD + kk * 16, p.qstr);
      qf[mc::kHDP / 16 - 1][2] = qf[mc::kHDP / 16 - 1][3] = 0u;   // columns 72..79
    }

    float mx[2] = {mc::kNegInf, mc::kNegInf};
    for (int j = 0; j < n_tiles; ++j) {
      __syncthreads();
      if (active) load_key_tile(Kt, kb, j * kKeyTile, p.L, p.hd, h);
      __syncthreads();
      if (!active) continue;
      float s[kKeyTile / 8][4];
      mc::qk_scores<kKeyTile / 8>(s, qf, Kt);
#pragma unroll
      for (int nt = 0; nt < kKeyTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * kKeyTile + nt * 8 + 2 * t + (e & 1);
          if (key < p.kv_valid) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e] * p.scale_log2e);
        }
    }
    mx[0] = mc::quad_max(mx[0]);
    mx[1] = mc::quad_max(mx[1]);

    float o[mc::kHDP / 8][4];
#pragma unroll
    for (int nt = 0; nt < mc::kHDP / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float l[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
      __syncthreads();
      if (active) {
        load_key_tile(Kt, kb, j * kKeyTile, p.L, p.hd, h);
        load_key_tile(Vt, vb, j * kKeyTile, p.L, p.hd, h);
      }
      __syncthreads();
      if (!active) continue;
      float s[kKeyTile / 8][4];
      mc::qk_scores<kKeyTile / 8>(s, qf, Kt);
#pragma unroll
      for (int nt = 0; nt < kKeyTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * kKeyTile + nt * 8 + 2 * t + (e & 1);
          const float sv = key < p.kv_valid ? s[nt][e] * p.scale_log2e : mc::kNegInf;
          const float pv = exp2f(sv - mx[e >> 1]);
          s[nt][e] = pv;
          l[e >> 1] += pv;
        }
      mc::pv_accumulate<kKeyTile / 8>(s, o, Vt);
    }
    if (!active) continue;
    const float l0 = mc::quad_sum(l[0]), l1 = mc::quad_sum(l[1]);
#pragma unroll
    for (int nt = 0; nt < mc::kHD / 8; ++nt) {
      bf16* o0 = QO + (ar + g) * p.qstr + h * mc::kHD + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(o0) = mc::pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
      *reinterpret_cast<uint32_t*>(o0 + 8 * p.qstr) =
          mc::pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
    }
  }
  __syncthreads();

  // Phase 3: out = o @ wo^T + bo [+ x].
  for (int n0 = 0; n0 < p.d_out; n0 += kBN) {
    gemm_chunk(acc, nullptr, 0, 0, QO, p.qstr, p.wo, n0, p.d_out, p.hd, stage);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = n0 + wc + nt * 8 + 2 * t;
      if (n >= p.d_out) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr + mi * 16 + g + half * 8;
        if (r >= rows) continue;
        float v0 = acc[mi][nt][2 * half] + p.bo[n];
        float v1 = acc[mi][nt][2 * half + 1] + p.bo[n + 1];
        if (p.residual) {
          const float2 xv = mc::unpack_bf16(
              *reinterpret_cast<const uint32_t*>(xb + (size_t)(m0 + r) * p.dm + n));
          v0 += xv.x;
          v1 += xv.y;
        }
        *reinterpret_cast<uint32_t*>(p.out + ((size_t)b * p.N + m0 + r) * p.d_out + n) =
            mc::pack_bf16(v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" int mc_fused_cross_attention(
    const void* x, const void* wq, const void* bq, const void* k,
    const void* v, const void* wo, const void* bo, void* out, int B, int N,
    int dm, int hd, int d_out, int H, int L, int kv_valid, float scale_log2e,
    int residual, void* stream) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.wq = static_cast<const bf16*>(wq);
  a.bq = static_cast<const float*>(bq);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.wo = static_cast<const bf16*>(wo);
  a.bo = static_cast<const float*>(bo);
  a.out = static_cast<bf16*>(out);
  a.N = N; a.dm = dm; a.hd = hd; a.d_out = d_out; a.H = H; a.L = L;
  a.kv_valid = kv_valid; a.residual = residual; a.scale_log2e = scale_log2e;
  a.qstr = (hd + kBK - 1) / kBK * kBK + 8;
  const size_t smem = (size_t)kBM * a.qstr * sizeof(bf16) + kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBM - 1) / kBM, B);
  cross_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
