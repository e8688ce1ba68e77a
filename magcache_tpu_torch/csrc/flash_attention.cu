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
// K1q, the qk-normed variant: the TPU kernel's norm=(true_d, eps) branch
// (_flash_kernel_bshd_fixed_max with norm, _rms_head), which STDiT3 runs on
// frames of more than 2,048 tokens (720p). Head dim 72, fixed max only (its
// callers all pass fixed_max; the RMS-normed scores are bounded). Rounding
// points:
//   - q and k: f32 sum of squares over the 72 values times 1/true_d, times
//     1/sqrt(var + eps), times the f32 gain [H, 72] (as _rms_head);
//   - q is then multiplied by scale*log2(e) in f32 and rounded to bf16 once;
//     k is rounded to bf16 (unlike K1 above, whose q is scaled in bf16);
//   - from there as K1's fixed-max variant.
// Two launches. (a) qk_norm_kernel reads the q and k column views of
// STDiT3's [frames, S, 3*H*72] qkv projection once, through their batch and
// token strides, and writes contiguous q^ (normed, scaled, rounded) and k^
// (normed, rounded): a per-head reduction and an elementwise map, bound by
// its bytes (about 1 GB at 720p, 0.3 ms). (b) The attention body of
// hopper_attention.cuh at head dim 72 carried as 80, <80, kFixed>, with
// q_scale = 1 (q^ is used as it is) on q^, k^ and v, the last read in place
// from the projection (token stride 6,912 bytes, head offset 144). The norm
// stays out of the product loop: the mma.sync kernel this replaces
// normalised every K tile again in each of a head's 57 query blocks.
//
// The pre-pass also serves K5 on groups of more than 16 tokens with gains or
// RoPE (grouped_attention.cu, route "prepass"): the gains are optional, and
// an optional interleaved-pair RoPE rotates each row in f32 by its in-group
// position token % group (f32 [group, 36] tables), after the norm and
// before q's scale, as magcache_tpu/ops/attention.py:_grouped_kernel
// rounds; k rows at in-group positions from group_valid on are neither read
// nor written. K1q's call (gains, no RoPE, group = valid = the sequence)
// does the same operations in the same order as before.
//
// What bounds K1q: at 720p one call is 4 x 30 x 16 x 3,600^2 x 72 = 1.79
// TFLOP over 1.0 GB of q/k/v/o: compute bound, 1.81 ms at 989 TFLOP/s; the
// 6.2e9 exp2 of the softmax take about as long again on the SFUs (16 a
// clock per SM), which the two consumer warpgroups taking turns overlap
// with the other's products.
//
// Plain C interface, loaded from Python with ctypes; the wrapper checks
// shapes, dtypes, strides and alignment, allocates the output and passes
// pointers and PyTorch's current stream. The launch returns
// cudaGetLastError().

#include "hopper_attention.cuh"

namespace {

using mc::bf16;

constexpr int kNormD = 72;                 // K1q's and K5's head dim
constexpr int kNormChunks = kNormD / 8;    // 16-byte chunks a head row
constexpr int kNormThreads = 32 * kNormChunks;   // 32 head rows a block

struct QkNormArgs {
  const bf16* src[2];                      // q, k: [B, S, H, 72] views
  bf16* dst[2];                            // q^, k^: contiguous [B, S, H, 72]
  const float* gain[2];                    // [H, 72], or null: no norm
  const float* cos;                        // [group, 36] or null: no RoPE
  const float* sin;
  long long bs[2], ts[2];                  // batch and token strides (elements)
  int S[2];                                // tokens a batch row
  int group[2];                            // positions a group (RoPE, valid)
  int valid[2];                            // in-group positions written
  int B, H;
  float scale[2];                          // scale*log2(e) for q, 1 for k
  float inv_true_d, eps;
};

// The pre-pass of K1q and of K5's groups of more than 16 tokens:
// blockIdx.y 0 takes q, 1 k. Thread i of a block takes 16-byte chunk i % 9
// of head row blockIdx.x * 32 + i / 9 (rows in [B, S, H] order, so
// neighbouring threads read neighbouring bytes of a token); the nine
// partial sums of squares of a row meet in shared memory. Rows at in-group
// positions past `valid` are neither read nor written. A chunk holds four
// whole RoPE pairs (2e, 2e + 1).
__global__ void __launch_bounds__(kNormThreads)
qk_norm_kernel(const QkNormArgs p) {
  __shared__ float part[kNormThreads];
  // the tensor's fields by selection, not by a dynamic index into the
  // parameters (which would copy them to local memory)
  const bool is_k = blockIdx.y == 1;
  const bf16* src = is_k ? p.src[1] : p.src[0];
  bf16* dst = is_k ? p.dst[1] : p.dst[0];
  const float* gain = is_k ? p.gain[1] : p.gain[0];
  const long long bs = is_k ? p.bs[1] : p.bs[0], ts = is_k ? p.ts[1] : p.ts[0];
  const int S = is_k ? p.S[1] : p.S[0];
  const int group = is_k ? p.group[1] : p.group[0];
  const int valid = is_k ? p.valid[1] : p.valid[0];
  const float scale = is_k ? p.scale[1] : p.scale[0];
  const long long rows = (long long)p.B * S * p.H;
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / kNormChunks;
  const int chunk = threadIdx.x % kNormChunks;
  int h = 0, pos = 0;
  bool live = row < rows;
  float f[8];
  float ss = 0.f;
  if (live) {
    h = (int)(row % p.H);
    const long long tok = row / p.H;
    const long long s = tok % S, b = tok / S;
    pos = (int)(s % group);
    live = pos < valid;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + b * bs + s * ts + h * kNormD +
                                                        chunk * 8);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = mc::unpack_bf16(w[j]);
        f[2 * j] = v.x;
        f[2 * j + 1] = v.y;
        ss += v.x * v.x + v.y * v.y;
      }
    }
  }
  part[threadIdx.x] = ss;
  __syncthreads();
  if (!live) return;
  if (gain != nullptr) {
    const float* mine = part + threadIdx.x / kNormChunks * kNormChunks;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < kNormChunks; ++j) var += mine[j];
    const float r = 1.f / sqrtf(var * p.inv_true_d + p.eps);
    const float4* g4 = reinterpret_cast<const float4*>(gain + h * kNormD + chunk * 8);
    const float4 ga = g4[0], gb = g4[1];
    const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = f[j] * r * g[j];
  }
  if (p.cos != nullptr) {
    // interleaved pairs, rotated by the in-group position, in f32
    const float4 c = *reinterpret_cast<const float4*>(p.cos + pos * (kNormD / 2) + chunk * 4);
    const float4 sn = *reinterpret_cast<const float4*>(p.sin + pos * (kNormD / 2) + chunk * 4);
    const float cc[4] = {c.x, c.y, c.z, c.w}, sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ye = f[2 * j], yo = f[2 * j + 1];
      f[2 * j] = ye * cc[j] - yo * sv[j];
      f[2 * j + 1] = ye * sv[j] + yo * cc[j];
    }
  }
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = mc::pack_bf16(f[2 * j] * scale, f[2 * j + 1] * scale);
  *reinterpret_cast<uint4*>(dst + row * kNormD + chunk * 8) = out;
}

}  // namespace

// The pre-pass (K1q (a); K5 on groups of more than 16 tokens): q^ [B, Sq,
// H, 72] and k^ [B, Sk, H, 72], contiguous, from the q and k views (batch
// and token strides in elements, unit channel stride, heads 72 apart): RMS
// norm with the f32 gains [H, 72] (or none: null), then RoPE at the
// in-group position token % group with the f32 [group, 36] tables (or none:
// null), then q times q_scale; rounded to bf16. Rows at in-group positions
// from q_valid (k_valid) on are not written. K1q: group = valid = Sq (Sk).
extern "C" int mc_qk_prepass(const void* q, const void* k, void* qn, void* kn, const void* qg,
                             const void* kg, const void* cos, const void* sin, int B, int Sq,
                             int Sk, int H, long long q_bs, long long q_ts, long long k_bs,
                             long long k_ts, int q_group, int k_group, int q_valid,
                             int k_valid, float q_scale, float inv_true_d, float eps,
                             void* stream) {
  QkNormArgs a{};
  a.src[0] = static_cast<const bf16*>(q);
  a.src[1] = static_cast<const bf16*>(k);
  a.dst[0] = static_cast<bf16*>(qn);
  a.dst[1] = static_cast<bf16*>(kn);
  a.gain[0] = static_cast<const float*>(qg);
  a.gain[1] = static_cast<const float*>(kg);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.bs[0] = q_bs; a.ts[0] = q_ts; a.bs[1] = k_bs; a.ts[1] = k_ts;
  a.S[0] = Sq; a.S[1] = Sk;
  a.group[0] = q_group; a.group[1] = k_group;
  a.valid[0] = q_valid; a.valid[1] = k_valid;
  a.B = B; a.H = H;
  a.scale[0] = q_scale; a.scale[1] = 1.f;
  a.inv_true_d = inv_true_d; a.eps = eps;
  const long long rows = (long long)B * (Sq > Sk ? Sq : Sk) * H;
  const dim3 grid((unsigned)((rows + 31) / 32), 2);
  qk_norm_kernel<<<grid, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K1q (b): o [B, Sq, H, 72] (element strides `o_strides`: batch, head,
// token) from q^, k^ and v [B, H, S, 72] views described by `maps` (q, k,
// v x a 64-wide and a 16-wide column box, ops/attention.py:flash_tma_maps);
// the fixed max m_const, q used as it is.
extern "C" int mc_flash_attention_qknorm_tma(const void* qn, const void* kn, const void* v,
                                             void* o, const long long* maps,
                                             const long long* o_strides, int B, int H,
                                             int Sq, int kv_len, float m_const,
                                             void* stream) {
  hopper::Args a{};
  a.o = static_cast<bf16*>(o);
  a.o_b = o_strides[0];
  a.o_h = o_strides[1];
  a.o_t = o_strides[2];
  a.H = H;
  a.Sq = Sq;
  a.kv_len = kv_len;
  a.q_scale = 1.f;
  a.m_const = m_const;
  const dim3 grid((Sq + hopper::kBlockM - 1) / hopper::kBlockM, B * H);
  return hopper::launch<80, hopper::kFixed>(qn, kn, v, maps, a, grid,
                                            static_cast<cudaStream_t>(stream));
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
