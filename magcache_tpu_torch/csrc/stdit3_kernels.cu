// K7, K6 and K8 on the Hopper bodies: the C entry points.
//
// K7 replaces magcache_tpu/ops/fused_prologue.py:lnmod_matmul (Pallas body
// _lnmod_mm_kernel):
//     out = [gelu](bf16(bf16(LN(x)) * (1 + scale) + shift) @ w + bias)
// K6 replaces magcache_tpu/ops/attention.py:fused_cross_attention (Pallas
// body _cross_fused_kernel):
//     out = [x +] (softmax(q k^T * scale) v) @ wo^T + bo,  q = x @ wq^T + bq
// over a short context (STDiT3's 300 caption tokens, Latte's 120).
// K8 replaces magcache_tpu/ops/fused_prologue.py:matmul_gated_residual
// (Pallas body _mm_gate_res_kernel), the DiT block's gated epilogue:
//     out = [resid +] gate * (x @ w + bias)
//
// Rounding points, as the TPU kernels have them:
//   K7: two-pass f32 LayerNorm (mean, then the variance of the centred
//       values), y = (x - mean) * rsqrt(var + eps) rounded to bf16, then
//       y * (1 + a) + b in f32 rounded to bf16 as the GEMM operand; f32
//       accumulate, + bias, tanh-gelu in f32, one rounding at the store.
//   K6: q = x @ wq^T in f32, + bq, rounded to bf16; scores in f32, times
//       scale * log2(e); keys at or past kv_valid masked; row-max softmax
//       p = exp2(s - max), l = sum of the f32 p, p rounded to bf16 before
//       PV, divided by l after; o rounded to bf16 before the
//       out-projection; f32 accumulate, + bo, + x in f32 when residual; one
//       rounding at the store.
//   K8: f32 accumulate + bias, rounded to bf16, * gate in f32; with a
//       residual rounded to bf16 again, then + resid in f32; one rounding
//       at the store. Pad rows (rows_out > S) are zeros, not gate * bias.
// Row geometry of K7: x is [B, S, K]; the output is [B, rows_out, N]. Output
// row (b, s) reads x row (b, s) when s < S and is written as zeros
// otherwise (the zero-filled attention-group pad). Modulation rows are
// b / batch_repeat. K8's rows: hopper_gemm.cuh (gate rows) and
// ops/gemm.py::gate_geometry. Weights come as nn.Linear weights, [N, K]
// with K contiguous.
//
// What bounds them on the H100: at STDiT3-XL/2 720p (2 x 54,000 tokens,
// width 1152) K7 is 0.86 (qkv) and 1.15 TFLOP (mlp1) over about 1.3 GB,
// K6 0.57 TFLOP of projections and 0.15 of attention over 0.5 GB, K8 0.29
// TFLOP (projections) and 1.15 (mlp2) over 0.3-1.2 GB: the tensor cores
// bound all of them.
//
// What the design does about it (the bodies' own notes say how):
//   K7: ln_modulate_kernel writes the normalised and modulated bf16
//       operand in one pass over x, then the GEMM body of hopper_gemm.cuh
//       (TMA ring, two wgmma consumer warpgroups, 128 x 192 tiles, TMA
//       stores) multiplies it with the bias or bias + gelu epilogue. Why the
//       modulation is not done inside the GEMM: hopper_gemm.cuh.
//   K6: three launches. (a) q = bf16(x @ wq^T + bq) on the GEMM body; (b)
//       the attention on hopper_cross_kernel (hopper_attention.cuh: K and V
//       of one (batch, head) resident, query tiles of 128 rows walked
//       through a Q ring, the exact row max with scores scaled after the
//       product); (c) out = bf16([x +] o @ wo^T + bo) on the GEMM body with
//       the residual epilogue. q and o make one round trip through device
//       memory each; the fused mma.sync kernel this replaces kept them in
//       shared memory but, holding a [64, 1152] tile there, re-read both
//       1152 x 1152 weights from L2 for every 64 rows.
//   K8: the GEMM body with the gate epilogue (kEpiGate, kEpiGateResid: the
//       residual tile brought in by TMA as K6's out-projection has it), on
//       flattened rows wherever rows_out == S.

#include "hopper_gemm.cuh"

namespace {

using hopper::bf16;

// K7's operand: y = bf16(bf16((x - mean) * rsqrt(var + eps)) * (1 + scale)
// + shift) for each row of x [B*S, K], the statistics two-pass in f32 (the
// mean, then the mean of the squared centred values), modulation row
// (row / S) / rep. One warp a row, 8 rows a block, K a multiple of 8; the
// row is read three times, the second and third from L1.
__global__ void __launch_bounds__(256)
ln_modulate_kernel(const bf16* x, const float* mod_a, const float* mod_b, bf16* y,
                   int rows, int S, int K, int rep, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * K;
  float sum = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = mc::unpack_bf16(w[j]);
      sum += v.x + v.y;
    }
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / K;
  float var = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = mc::unpack_bf16(w[j]);
      const float c0 = v.x - mean, c1 = v.y - mean;
      var += c0 * c0 + c1 * c1;
    }
  }
  for (int o = 16; o > 0; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
  const float rstd = rsqrtf(var / K + eps);
  const size_t mrow = (size_t)(row / S / rep) * K;
  bf16* yr = y + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
    const float4* pa = reinterpret_cast<const float4*>(mod_a + mrow + k);
    const float4* pb = reinterpret_cast<const float4*>(mod_b + mrow + k);
    const float4 a4[2] = {pa[0], pa[1]}, b4[2] = {pb[0], pb[1]};
    const float* ma = reinterpret_cast<const float*>(a4);
    const float* mb = reinterpret_cast<const float*>(b4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = mc::unpack_bf16(w[j]);
      const float y0 = mc::round_bf16((v.x - mean) * rstd);
      const float y1 = mc::round_bf16((v.y - mean) * rstd);
      w[j] = mc::pack_bf16(y0 * ma[2 * j] + mb[2 * j], y1 * ma[2 * j + 1] + mb[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(yr + k) = raw;
  }
}

}  // namespace

// K7's operand: y [B, S, K] from x (ln_modulate_kernel); scale1p is
// 1 + scale and shift, f32 [B / rep, K].
extern "C" int mc_ln_modulate(const void* x, const void* scale1p, const void* shift, void* y,
                              int B, int S, int K, int rep, float eps, void* stream) {
  const int rows = B * S;
  ln_modulate_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale1p),
      static_cast<const float*>(shift), static_cast<bf16*>(y), rows, S, K, rep, eps);
  return (int)cudaGetLastError();
}

// The GEMM body: out [B, rows_out, N] = epilogue(A [B, S, K] @ w^T) with the
// tensor maps of A, w, out (and resid) in `words` (3 or 4 x 16); epi: 0
// bias, 1 bias + gelu, 2 bias + resid [B, S, N].
extern "C" int mc_hopper_gemm(const void* x, const void* w, const long long* words,
                              void* out, const void* bias, const void* resid, int B, int S,
                              int rows_out, int K, int N, int epi, void* stream) {
  hopper::GemmArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.B = B; a.S = S; a.rows_out = rows_out; a.K = K; a.N = N;
  a.m_tiles = (rows_out + hopper::kGemmBM - 1) / hopper::kGemmBM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace hopper;
  switch (epi) {
    case kEpiBias: return launch_gemm<kEpiBias>(x, w, out, resid, words, a, st);
    case kEpiGelu: return launch_gemm<kEpiGelu>(x, w, out, resid, words, a, st);
    case kEpiResid: return launch_gemm<kEpiResid>(x, w, out, resid, words, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K8: out [B, rows_out, N] = [resid +] gate * (A [B, S, K] @ w^T + bias),
// gate row b / rep + s / span of `gate` (f32 rows of N); the maps of A, w,
// out (and resid [B, rows_out, N]) in `words`. resid may be null.
extern "C" int mc_matmul_gated_residual(const void* x, const void* w, const long long* words,
                                        void* out, const void* bias, const void* gate,
                                        const void* resid, int B, int S, int rows_out, int K,
                                        int N, int rep, int span, void* stream) {
  if (rep < 1 || span < 1) return (int)cudaErrorInvalidValue;
  hopper::GemmArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.gate = static_cast<const float*>(gate);
  a.B = B; a.S = S; a.rows_out = rows_out; a.K = K; a.N = N;
  a.m_tiles = (rows_out + hopper::kGemmBM - 1) / hopper::kGemmBM;
  a.rep = rep; a.span = span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace hopper;
  return resid ? launch_gemm<kEpiGateResid>(x, w, out, resid, words, a, st)
               : launch_gemm<kEpiGate>(x, w, out, nullptr, words, a, st);
}

// K6's attention stage: o [B, N, H*72] from q [B, N, H*72] and k, v
// [B, L, H*72] (six maps in `words`), kv_valid <= 512 keys, each block
// walking `tiles_per_block` query tiles of one (batch, head).
extern "C" int mc_cross_attention_tma(const void* q, const void* k, const void* v,
                                      const long long* words, void* o, int B, int N,
                                      int H, int kv_valid, int tiles_per_block,
                                      float q_scale, void* stream) {
  if (kv_valid < 1 || kv_valid > hopper::kCrossKeyTiles * hopper::kBlockN)
    return (int)cudaErrorInvalidValue;
  hopper::CrossArgs a{};
  a.o = static_cast<bf16*>(o);
  a.H = H; a.N = N; a.kv_valid = kv_valid; a.tiles_per_block = tiles_per_block;
  a.q_scale = q_scale;
  const int n_qt = (N + hopper::kBlockM - 1) / hopper::kBlockM;
  const int blocks = (n_qt + tiles_per_block - 1) / tiles_per_block;
  return hopper::launch_cross(q, k, v, words, a, blocks, B * H,
                              static_cast<cudaStream_t>(stream));
}
