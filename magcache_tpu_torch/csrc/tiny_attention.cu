// K9: tiny-sequence attention over the fused qkv projection, everything in
// f32: optional per-head RMS qk-norm and interleaved-pair RoPE, then softmax
// attention over T <= 32 frames, for T-frame groups of rows.
//
// Replaces magcache_tpu/ops/tiny_attention.py:tiny_temporal_attention (the
// "vpu" mode, Pallas body _kernel). qkv is [R, T, 3*H*D] bf16 with columns
// q|k|v by head; the output is [R, T, H*D] bf16; row r's T tokens attend to
// each other, head by head.
//
// Math, point for point as the TPU kernel computes it (nothing is rounded
// before the store):
//   - q and k taken to f32; with gains, x * (rsqrt(mean(x^2) + eps) * gain)
//     over the head's D values; with RoPE, the interleaved-pair rotation by
//     the frame index; q then times scale * log2(e);
//   - f32 scores, each row's max over its T keys, p = exp2(s - max) in f32
//     (not rounded), l the f32 sum of p;
//   - acc = sum over keys of p * v in f32 (v bf16 taken to f32), times 1/l,
//     rounded to bf16 at the store.
//
// What bounds it on the H100: at Latte-1's temporal shape (2,048 rows of
// 16 frames, 16 heads of 72) the products are 2.4 GFLOP of f32 and the
// traffic 302 MB (qkv read once, the output written once): memory-bound,
// 0.090 ms at 3.35 TB/s. The T x T score tile is far too small to fill an
// mma tile, and the TPU kernel keeps every product in f32, so this one runs
// on the CUDA cores.
//
// What the design does about it: one thread per (row, head, frame), a block
// per row and a group of heads (about 64 threads). Each thread normalises,
// rotates and stores its own k row to shared memory in f32 (rows D + 4 wide,
// float4 reads without bank conflicts) and copies its v row there as bf16;
// q is read in chunks of 8 straight from global memory and never stored. A
// thread keeps its row's T scores in registers, takes the max and the exp2
// there, and accumulates p * v chunk by chunk from shared memory, where the
// threads of one head read the same k and v rows (broadcasts). qkv is read
// once; no tensor cores, no cp.async.

#include "mma_tile.cuh"

namespace {

using mc::bf16;

constexpr int kMaxT = 32;

struct Args {
  const bf16* qkv;      // [R, T, 3*H*D]
  bf16* out;            // [R, T, H*D]
  const float* qg;      // [H, D], or null: no qk-norm
  const float* kg;
  const float* cos;     // [T, D/2] or null: no RoPE
  const float* sin;
  int T, H, D, hpb;     // hpb: heads per block
  float q_scale, inv_d, eps;
};

__device__ __forceinline__ void load8(const bf16* src, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = mc::unpack_bf16(w[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// rsqrt(mean(x^2) + eps) over a head row of D values (1 without a gain).
__device__ __forceinline__ float norm_factor(const bf16* row, const float* gain,
                                             const Args& p) {
  if (gain == nullptr) return 1.f;
  float ss = 0.f;
  for (int c = 0; c < p.D; c += 8) {
    float f[8];
    load8(row + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
  }
  return rsqrtf(ss * p.inv_d + p.eps);
}

// Values c..c+7 of a head row: x * (inv * gain) [with gains], rotated by
// the angles cs/sn [with RoPE], times mult; all in f32.
__device__ __forceinline__ void prep8(float* f, const bf16* row, int c, const float* gain,
                                      float inv, const float* cs, const float* sn,
                                      float mult) {
  load8(row + c, f);
  if (gain != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i] * (inv * gain[c + i]);
  }
  if (cs != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float co = cs[c / 2 + i], si = sn[c / 2 + i];
      const float re = f[2 * i] * co + (-f[2 * i + 1]) * si;
      const float ro = f[2 * i + 1] * co + f[2 * i] * si;
      f[2 * i] = re;
      f[2 * i + 1] = ro;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] *= mult;
}

__global__ void __launch_bounds__(256)
tiny_attention_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kstr = p.D + 4;              // f32 per k row
  const int vstr = p.D + 8;              // bf16 per v row
  float* Ks = reinterpret_cast<float*>(smem_raw);                   // [hpb][T][kstr]
  bf16* Vs = reinterpret_cast<bf16*>(Ks + (size_t)p.hpb * p.T * kstr);  // [hpb][T][vstr]
  const int r = blockIdx.x;
  const int hl = threadIdx.x / p.T, t = threadIdx.x % p.T;
  const int h = blockIdx.y * p.hpb + hl;
  const bool active = hl < p.hpb && h < p.H;
  const int hd = p.H * p.D;
  const bf16* qrow = p.qkv + ((size_t)r * p.T + t) * 3 * hd + (size_t)h * p.D;
  const float* cs = p.cos ? p.cos + (size_t)t * (p.D / 2) : nullptr;
  const float* sn = p.sin ? p.sin + (size_t)t * (p.D / 2) : nullptr;
  const float* qg = p.qg ? p.qg + (size_t)h * p.D : nullptr;
  const float* kg = p.kg ? p.kg + (size_t)h * p.D : nullptr;

  if (active) {
    const bf16* krow = qrow + hd;
    const float inv = norm_factor(krow, kg, p);
    float* kd = Ks + ((size_t)hl * p.T + t) * kstr;
    bf16* vd = Vs + ((size_t)hl * p.T + t) * vstr;
    for (int c = 0; c < p.D; c += 8) {
      float f[8];
      prep8(f, krow, c, kg, inv, cs, sn, 1.f);
      *reinterpret_cast<float4*>(kd + c) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(kd + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
      *reinterpret_cast<uint4*>(vd + c) = *reinterpret_cast<const uint4*>(qrow + 2 * hd + c);
    }
  }
  __syncthreads();
  if (!active) return;

  const float* Kh = Ks + (size_t)hl * p.T * kstr;
  const bf16* Vh = Vs + (size_t)hl * p.T * vstr;
  const float inv = norm_factor(qrow, qg, p);
  float s[kMaxT];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) s[j] = 0.f;
  for (int c = 0; c < p.D; c += 8) {
    float f[8];
    prep8(f, qrow, c, qg, inv, cs, sn, p.q_scale);
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < p.T) {
        const float4 a = *reinterpret_cast<const float4*>(Kh + j * kstr + c);
        const float4 b = *reinterpret_cast<const float4*>(Kh + j * kstr + c + 4);
        s[j] += f[0] * a.x + f[1] * a.y + f[2] * a.z + f[3] * a.w +
                f[4] * b.x + f[5] * b.y + f[6] * b.z + f[7] * b.w;
      }
    }
  }
  float m = mc::kNegInf;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j)
    if (j < p.T) m = fmaxf(m, s[j]);
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j)
    if (j < p.T) {
      s[j] = exp2f(s[j] - m);
      l += s[j];
    }
  const float rl = 1.f / l;
  bf16* orow = p.out + ((size_t)r * p.T + t) * hd + (size_t)h * p.D;
  for (int c = 0; c < p.D; c += 8) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < p.T) {
        float v[8];
        load8(Vh + j * vstr + c, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += s[j] * v[i];
      }
    }
    uint4 packed;
    uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = mc::pack_bf16(acc[2 * i] * rl, acc[2 * i + 1] * rl);
    *reinterpret_cast<uint4*>(orow + c) = packed;
  }
}

}  // namespace

extern "C" int mc_tiny_attention(const void* qkv, void* out, const void* qg,
                                 const void* kg, const void* cos, const void* sin,
                                 int R, int T, int H, int D, float q_scale, float eps,
                                 void* stream) {
  Args a{};
  a.qkv = static_cast<const bf16*>(qkv);
  a.out = static_cast<bf16*>(out);
  a.qg = static_cast<const float*>(qg);
  a.kg = static_cast<const float*>(kg);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.T = T;
  a.H = H;
  a.D = D;
  const int per_block = T < 64 ? 64 / T : 1;   // about 64 threads a block
  a.hpb = per_block < H ? per_block : H;
  a.q_scale = q_scale;
  a.inv_d = 1.f / D;
  a.eps = eps;
  const size_t smem = (size_t)a.hpb * T * ((D + 4) * sizeof(float) + (D + 8) * sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      tiny_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R, (H + a.hpb - 1) / a.hpb);
  tiny_attention_kernel<<<grid, a.hpb * T, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
