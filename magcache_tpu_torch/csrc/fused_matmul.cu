// K8: the STDiT3 trunk's gated projection epilogue, bf16, on mma.sync.
//
// K8 replaces magcache_tpu/ops/fused_prologue.py:matmul_gated_residual
// (Pallas body _mm_gate_res_kernel):
//     out = [bf16(resid +)] gate * bf16(x @ w + bias)
// (K7, lnmod_matmul, runs on the wgmma/TMA GEMM body of hopper_gemm.cuh:
// stdit3_kernels.cu.)
//
// Rounding points, as the TPU kernel has them: f32 accumulate + bias, round
// to bf16, * gate in f32; with a residual, round to bf16 again, then + resid
// in f32; one rounding at the store.
// Row geometry: x is [B, S, K]; the output is [B, rows_out, N]. Output row
// (b, s) reads x row (b, s) when s < S and is written as zeros otherwise
// (rows_out < S drops rows). Gate rows are b / batch_repeat.
// Weights come as an nn.Linear weight, [N, K] with K contiguous.
//
// What bounds it on the H100: at STDiT3-XL/2 480p the calls are 47,700 x
// 1152 -> 1152 (proj) and 47,700 x 4608 -> 1152 (mlp2): 0.13-0.5 TFLOP each
// over well under a GB, hundreds of flops per byte, so the tensor cores
// bound them.
//
// What the design does about that: every product runs on
// mma.sync.m16n8k16 fed by ldmatrix from padded (conflict-free) shared
// memory, with k-steps of 64 and a 3-stage cp.async pipeline (tiles land in
// shared memory without passing through registers; one barrier per
// k-step): 128 x 128 block tiles, 8 warps of 64 x 32, A and W both
// pipelined; two blocks fit on an SM. The epilogue applies bias, gate and
// residual to the accumulators and writes bf16 pairs. No wgmma/TMA yet.

#include "mma_tile.cuh"

namespace {

using mc::bf16;

constexpr int kStages = 3;
constexpr int kThreads = 256;              // 8 warps
// K8: 128 x 128 tiles, k-steps of 64 (staged rows of 144 B, conflict-free)
constexpr int kBK = 64;
constexpr int kStr = kBK + 8;
constexpr int kBN = 128;
constexpr int kGateBM = 128;
constexpr size_t kGateSmem = (size_t)kStages * (kGateBM + kBN) * kStr * sizeof(bf16);

struct Args {
  const bf16* x;          // [B, S, K]
  const bf16* w;          // [N, K]
  const float* bias;      // [N]
  const float* gate;      // K8: [B / rep, N]
  const bf16* resid;      // K8: [B, rows_out, N] or null
  bf16* out;              // [B, rows_out, N]
  int B, S, rows_out, K, N, rep;
};

// Output row m of [B, rows_out, N]: its batch row, and the x row it reads
// (null for a pad row, s >= S, which is written as zeros).
__device__ __forceinline__ const bf16* x_row(const Args& p, int m, int* b) {
  *b = m / p.rows_out;
  const int s = m - *b * p.rows_out;
  if (m >= p.B * p.rows_out || s >= p.S) return nullptr;
  return p.x + ((size_t)*b * p.S + s) * p.K;
}

// W rows n0..n0+kRows-1, k columns k0..k0+kK-1 into one pipeline stage
// (rows of kK + 8 elements).
template <int kRows, int kK>
__device__ __forceinline__ void load_w_stage(bf16* Ws, const Args& p, int n0, int k0) {
  constexpr int kCh = kK / 8;
#pragma unroll
  for (int i = 0; i < kRows * kCh / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kCh, k = k0 + (c % kCh) * 8, n = n0 + r;
    const bool ok = n < p.N && k < p.K;
    mc::cp_async_16(Ws + r * (kK + 8) + (c % kCh) * 8,
                    ok ? p.w + (size_t)n * p.K + k : p.w, ok);
  }
}

// acc += A[kMT m16 tiles of rows, kK k] * B[kNT n8 tiles of rows, kK k]^T.
template <int kMT, int kNT, int kK>
__device__ __forceinline__ void mma_kstep(float (*acc)[kNT][4], const bf16* A, int lda,
                                          const bf16* B, int ldb) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    uint32_t af[kMT][4], bfr[kNT / 2][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) mc::load_a_frag(af[mi], A + mi * 16 * lda + kk * 16, lda);
#pragma unroll
    for (int nj = 0; nj < kNT / 2; ++nj)
      mc::load_b_frag_nk(bfr[nj], B + nj * 16 * ldb + kk * 16, ldb);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int nj = 0; nj < kNT / 2; ++nj) {
        mc::mma_16816(acc[mi][2 * nj], af[mi], bfr[nj][0], bfr[nj][1]);
        mc::mma_16816(acc[mi][2 * nj + 1], af[mi], bfr[nj][2], bfr[nj][3]);
      }
  }
}

// ---- K8 ---------------------------------------------------------------------
template <bool kResid>
__global__ void __launch_bounds__(kThreads)
gated_matmul_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);          // kStages x [128][72]
  bf16* Ws = As + kStages * kGateBM * kStr;           // kStages x [128][72]
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kGateBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;            // warp tile 64 x 32

  constexpr int kARows = kGateBM * (kBK / 8) / kThreads;   // 4 rows a thread
  const bf16* arow[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    int b;
    arow[i] = x_row(p, m0 + (threadIdx.x >> 3) + i * (kThreads / 8), &b);
  }
  auto load_stage = [&](int st, int kt) {
    const int k = kt * kBK + (threadIdx.x & 7) * 8;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const bool ok = arow[i] != nullptr && k < p.K;
      mc::cp_async_16(As + st * kGateBM * kStr + ((threadIdx.x >> 3) + i * (kThreads / 8)) * kStr +
                          (threadIdx.x & 7) * 8,
                      ok ? arow[i] + k : p.x, ok);
    }
    load_w_stage<kBN, kBK>(Ws + st * kBN * kStr, p, n0, kt * kBK);
  };

  const int nk = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    mc::cp_async_commit();
  }
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    mc::cp_async_wait<kStages - 2>();
    __syncthreads();             // stage kt landed; stage kt-1 is free
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    mc::cp_async_commit();
    const int st = kt % kStages;
    mma_kstep<4, 4, kBK>(acc, As + st * kGateBM * kStr + wm * 64 * kStr, kStr,
                         Ws + st * kBN * kStr + wn * 32 * kStr, kStr);
  }
  mc::cp_async_wait<0>();

  // Epilogue: f32 + bias, round, * gate [, round, + resid], round; pad rows 0.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= p.B * p.rows_out) continue;
      int b;
      const bool live = x_row(p, m, &b) != nullptr;
      const float* grow = p.gate + (size_t)(b / p.rep) * p.N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t;
        if (n >= p.N) continue;
        float v0 = 0.f, v1 = 0.f;
        if (live) {
          v0 = mc::round_bf16(acc[mi][ni][2 * half] + p.bias[n]) * grow[n];
          v1 = mc::round_bf16(acc[mi][ni][2 * half + 1] + p.bias[n + 1]) * grow[n + 1];
          if (kResid) {
            const float2 r = mc::unpack_bf16(
                *reinterpret_cast<const uint32_t*>(p.resid + (size_t)m * p.N + n));
            v0 = mc::round_bf16(v0) + r.x;
            v1 = mc::round_bf16(v1) + r.y;
          }
        }
        *reinterpret_cast<uint32_t*>(p.out + (size_t)m * p.N + n) = mc::pack_bf16(v0, v1);
      }
    }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K8. resid may be null.
extern "C" int mc_matmul_gated_residual(const void* x, const void* w,
                                        const void* bias, const void* gate,
                                        const void* resid, void* out, int B,
                                        int S, int rows_out, int K, int N,
                                        int rep, void* stream) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.gate = static_cast<const float*>(gate);
  a.resid = static_cast<const bf16*>(resid);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.S = S; a.rows_out = rows_out; a.K = K; a.N = N; a.rep = rep;
  const dim3 grid((N + kBN - 1) / kBN, (B * rows_out + kGateBM - 1) / kGateBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resid ? launch(gated_matmul_kernel<true>, grid, kGateSmem, a, st)
               : launch(gated_matmul_kernel<false>, grid, kGateSmem, a, st);
}
