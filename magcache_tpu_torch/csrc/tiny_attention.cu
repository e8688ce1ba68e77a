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
// Two kernels, chosen by T and D alone (ops/tiny_attention.py:
// tiny_kernel_route):
//   - "stream" (T <= 16, D = 72: every caller's shape), tiny_stream_kernel
//     on the skeleton of K5's stream route (stream_ring.cuh): persistent
//     blocks, one an SM, walk a contiguous range of stages (one group's
//     heads 8j .. 8j + 7); a producer warp copies each stage's q, k and v
//     as three TMA boxes (72 columns x 16 frames x 8 heads, frames past T
//     and heads past H zeros, not read) into a ring of two stages. Eight
//     consumer warps take one (group, head) each a stage. Lane (rp, cq) =
//     (lane & 7, lane >> 3) takes rows rp and rp + 8, columns 18 cq ..
//     18 cq + 17: it holds that part of q in f32 registers, normed (a
//     row's sum of squares over its four lanes by two shuffles), rotated
//     and scaled, writes the same part of k^ (normed, rotated) and of v to
//     the warp's f32 scratch rows, each value widened from bf16 once, and
//     releases the stage. Its partial scores against the 16 keys (each key
//     value a broadcast to the 8 lanes of one cq, used for two rows) are
//     summed over the row's four lanes by a reduce-scatter (the four lanes
//     take the keys in four orders, so that each is left its own four
//     keys), each lane takes the max, the exp2 and the sum of its four
//     keys, completed over the four lanes by shuffles, and an all-gather
//     brings every p back; P V runs over its 18 columns, and the output
//     rows go through the scratch rows as bf16 and out in 16-byte stores.
//     Norm and RoPE are template parameters; the gains and tables stay in
//     shared memory; the ring is written only by the copy engine, so no
//     proxy fence sits in the loop. Shared memory: the ring 2 x 55,296 B,
//     the scratch rows 8 x 9,728 B, the gains 2 x H x 288 B and the tables
//     2 x T x 144 B: 202,400 B at 16 heads and 16 frames. What holds it
//     back is the consumers' issue rate (PERF.md: 2 warps a scheduler,
//     about 2,000 instructions a task, 1,152 of them products), not the
//     copies: without its products and exp2 it streams at 2.3 TB/s;
//   - "general" (any other T <= 32 and D a multiple of 8 up to 128),
//     tiny_attention_kernel: one thread per (row, head, frame), a block per
//     row and a group of heads (about 64 threads). Each thread normalises,
//     rotates and stores its own k row to shared memory in f32 (rows D + 4
//     wide) and copies its v row there as bf16; q is read in chunks of 8
//     straight from global memory. A thread keeps its row's T scores in
//     registers and accumulates p * v chunk by chunk from shared memory.
//     Its loads are synchronous, 16 bytes a thread and 6,912 bytes apart,
//     q and k are read twice, and about 14 warps fit an SM: 0.66 TB/s at
//     Latte's shape on an H100 (PERF.md), hence the stream route.

#include "mma_tile.cuh"
#include "stream_ring.cuh"

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

// ---- the stream route: T <= 16, D = 72 -------------------------------------

using stream_ring::kBoxElems;
using stream_ring::kD;                              // 72
using stream_ring::kRows;
using stream_ring::kSlotElems;
using stream_ring::kSlots;
using stream_ring::kStageElems;
using stream_ring::kThreads;
using stream_ring::StreamMaps;

constexpr int kRing = 2;                            // stages in shared memory
constexpr int kCols = kD / 4;                       // a lane's 18 columns
constexpr int kPairs = kCols / 2;
// f32 a scratch row: at 76 the 8-byte stores of a half-warp (8 rows, 2
// column groups) fall on distinct banks
constexpr int kFStr = kD + 4;
constexpr int kChunks = kD / 8;                     // 16-byte chunks of a bf16 row

struct StreamArgs {
  bf16* out;            // [R, T, H*72]
  const float* qg;      // [H, 72], or null: no qk-norm
  const float* kg;
  const float* cos;     // [T, 36] or null: no RoPE
  const float* sin;
  int T, H, gpb;        // gpb: groups (rows) a batch row of the maps
  int n_stages, per_block;                          // stages; a block's range
  float q_scale, inv_d, eps;
};

// Two bf16 values (low, high half of w) in f32 by integer operations: the
// low one shifted up, the high one masked (9% faster here than cuda_bf16's
// conversion on an H100, PERF.md section 6).
__device__ __forceinline__ float2 widen(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// A lane's 18 bf16 values of a row at src (4-byte aligned) in f32.
__device__ __forceinline__ void load_cols(float* f, const bf16* src) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const float2 x = widen(reinterpret_cast<const uint32_t*>(src)[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// A lane's 18 values of a q or k head row, in place: with kNorm x * (rsqrt(
// mean(x^2) + eps) * gain) over the row's 72 values (the sums of squares of
// the row's other three lanes, lane ^ 8 and lane ^ 16, by two shuffles),
// with kRope the interleaved-pair rotation by the angles cs/sn of its 9
// pairs. Every lane of the warp calls it.
template <bool kNorm, bool kRope>
__device__ __forceinline__ void prep_cols(float* f, const float* gain, const float* cs,
                                          const float* sn, float inv_d, float eps) {
  if (kNorm) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) ss += f[i] * f[i];
    ss += __shfl_xor_sync(0xffffffffu, ss, 8);
    ss += __shfl_xor_sync(0xffffffffu, ss, 16);
    const float inv = rsqrtf(ss * inv_d + eps);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const float2 g = reinterpret_cast<const float2*>(gain)[i];
      f[2 * i] = f[2 * i] * (inv * g.x);
      f[2 * i + 1] = f[2 * i + 1] * (inv * g.y);
    }
  }
  if (kRope) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const float c = cs[i], s = sn[i];
      const float re = f[2 * i] * c + (-f[2 * i + 1]) * s;
      const float ro = f[2 * i + 1] * c + f[2 * i] * s;
      f[2 * i] = re;
      f[2 * i + 1] = ro;
    }
  }
}

// A persistent block streams stages [blockIdx.x * per_block, + per_block)
// through the ring; stage s is heads 8(s % hc) .. + 7 of group s / hc,
// hc = ceil(H / 8). Warps 0..7 are consumers (warp w takes head slot w);
// warp 8 is the producer. Consumer lane (rp, cq) = (lane & 7, lane >> 3)
// takes rows rp and rp + 8, columns 18 cq .. 18 cq + 17.
template <bool kNorm, bool kRope>
__global__ void __launch_bounds__(kThreads, 1)
tiny_stream_kernel(const __grid_constant__ StreamMaps maps, const StreamArgs p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(stream_ring::aligned_smem(smem_raw));
  float* scratch = reinterpret_cast<float*>(ring + kRing * kStageElems);   // [8][2][16][76]
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch + kSlots * 2 * kRows * kFStr);
  uint64_t* empty = full + kRing;
  float* gains = reinterpret_cast<float*>(empty + kRing);          // [2][H][72]
  float* tabs = gains + (kNorm ? 2 * p.H * kD : 0);                // [2][T][36]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hc = (p.H + kSlots - 1) / kSlots;
  const int s0 = blockIdx.x * p.per_block;
  const int s1 = min(p.n_stages, s0 + p.per_block);

  if (kNorm)
    for (int i = tid; i < 2 * p.H * kD; i += kThreads)
      gains[i] = i < p.H * kD ? p.qg[i] : p.kg[i - p.H * kD];
  if (kRope)
    for (int i = tid; i < 2 * p.T * (kD / 2); i += kThreads)
      tabs[i] = i < p.T * (kD / 2) ? p.cos[i] : p.sin[i - p.T * (kD / 2)];
  if (tid == 0) stream_ring::init_barriers<kRing>(full, empty);
  __syncthreads();

  if (warp == kSlots) {
    // ---- producer: frames past T and heads past H arrive as zeros
    if (lane == 0) stream_ring::produce<kRing>(maps, ring, full, empty, s0, s1, hc, p.gpb);
    return;
  }

  // ---- consumers
  const int rp = lane & 7, c0 = (lane >> 3) * kCols;
  const int xm = ((lane >> 4) << 3) | (((lane >> 3) & 1) << 2);   // see the scores
  const size_t ld = (size_t)p.H * kD;
  float* Kf = scratch + warp * 2 * kRows * kFStr;   // k^ in f32, rows 76 apart
  float* Vf = Kf + kRows * kFStr;                   // v in f32
  bf16* O = reinterpret_cast<bf16*>(Kf);            // then the output rows [16][72]
  // RoPE angles of rows rp and rp + 8 (rows past T are zeros: any angle)
  const float* cs[2];
  const float* sn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cs[r] = tabs + min(rp + 8 * r, p.T - 1) * (kD / 2) + c0 / 2;
    sn[r] = cs[r] + p.T * (kD / 2);
  }
  for (int s = s0, it = 0; s < s1; ++s, ++it) {
    const int buf = it % kRing;
    const int g = s / hc, h = (s % hc) * kSlots + warp;
    const bf16* Qs = ring + buf * kStageElems + warp * kSlotElems;
    const bf16* Ks = Qs + kBoxElems;
    const bf16* Vs = Qs + 2 * kBoxElems;
    // every warp waits, so none arrives on a stage's "empty" ahead of it
    hopper::mbar_wait(&full[buf], (it / kRing) & 1);
    if (h >= p.H) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[buf]);
      continue;
    }
    // q^ to registers; k^ and v to the warp's f32 rows, each value widened
    // once; then the stage is free for the next copy
    float q[2][kCols];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rp + 8 * r;
      float k[kCols], v[kCols];
      load_cols(q[r], Qs + row * kD + c0);
      load_cols(k, Ks + row * kD + c0);
      load_cols(v, Vs + row * kD + c0);
      prep_cols<kNorm, kRope>(q[r], gains + h * kD + c0, cs[r], sn[r], p.inv_d, p.eps);
      prep_cols<kNorm, kRope>(k, gains + (p.H + h) * kD + c0, cs[r], sn[r], p.inv_d,
                              p.eps);
#pragma unroll
      for (int c = 0; c < kCols; ++c) q[r][c] *= p.q_scale;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        reinterpret_cast<float2*>(Kf + row * kFStr + c0)[i] =
            make_float2(k[2 * i], k[2 * i + 1]);
        reinterpret_cast<float2*>(Vf + row * kFStr + c0)[i] =
            make_float2(v[2 * i], v[2 * i + 1]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[buf]);

    // scores of rows rp, rp + 8 over the lane's 18 columns, then the row's
    // other three lanes'
    // Slot k of a lane holds key k ^ xm: the four lanes of a row (cq = 0..3)
    // take the keys in four orders, so that a reduce-scatter leaves each
    // lane its own four keys (slots 0..3: keys xm .. xm + 3) and an
    // all-gather brings the rest back into the same slots. kb[b]: the
    // scratch row of key 4 b ^ xm.
    float sc[2][kRows];
    const float* kb[4];
    const float* vb[4];
#pragma unroll
    for (int bl = 0; bl < 4; ++bl) {
      kb[bl] = Kf + ((4 * bl) ^ xm) * kFStr + c0;
      vb[bl] = Vf + ((4 * bl) ^ xm) * kFStr + c0;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) sc[0][k] = sc[1][k] = 0.f;
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float2 x = reinterpret_cast<const float2*>(kb[k >> 2] + (k & 3) * kFStr)[i];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          sc[r][k] = fmaf(q[r][2 * i + 1], x.y, fmaf(q[r][2 * i], x.x, sc[r][k]));
      }
    // reduce-scatter over the row's four lanes: lane ^ 16 holds keys k ^ 8 in
    // slot k, lane ^ 8 keys k ^ 4
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < 8; ++k) sc[r][k] += __shfl_xor_sync(0xffffffffu, sc[r][k + 8], 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[r][k] += __shfl_xor_sync(0xffffffffu, sc[r][k + 4], 8);
    }
    // softmax: the row's max and sum over its four lanes, each lane's four
    // exp2 of its own keys; then the all-gather of p
    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = mc::kNegInf;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (xm + k < p.T) m = fmaxf(m, sc[r][k]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sc[r][k] = xm + k < p.T ? exp2f(sc[r][k] - m) : 0.f;
        sum += sc[r][k];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      l[r] = sum + __shfl_xor_sync(0xffffffffu, sum, 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[r][k + 4] = __shfl_xor_sync(0xffffffffu, sc[r][k], 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) sc[r][k + 8] = __shfl_xor_sync(0xffffffffu, sc[r][k], 16);
    }
    // P V over the lane's 18 columns (keys past T add 0 * 0: their p is 0
    // and their v rows are zeros)
    float acc[2][kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[0][c] = acc[1][c] = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const float2 x = reinterpret_cast<const float2*>(vb[k >> 2] + (k & 3) * kFStr)[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[r][2 * i] += sc[r][k] * x.x;
          acc[r][2 * i + 1] += sc[r][k] * x.y;
        }
      }
    __syncwarp();                 // k^ and v are read: the output takes their rows
    // the output, times 1 / l, rounded once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rl = 1.f / l[r];
      uint32_t* o = reinterpret_cast<uint32_t*>(O + (rp + 8 * r) * kD + c0);
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
        o[i] = mc::pack_bf16(acc[r][2 * i] * rl, acc[r][2 * i + 1] * rl);
    }
    __syncwarp();
    bf16* dst = p.out + (size_t)g * p.T * ld + h * kD;
    for (int i = lane; i < p.T * kChunks; i += 32) {
      const int row = i / kChunks, c = i % kChunks;
      *reinterpret_cast<uint4*>(dst + row * ld + c * 8) =
          *reinterpret_cast<const uint4*>(O + row * kD + c * 8);
    }
    __syncwarp();                 // the rows are read: the next task's k^ takes them
  }
}

template <bool kNorm, bool kRope>
int launch_stream(const StreamMaps& m, const StreamArgs& a, int grid, int smem_bytes,
                  cudaStream_t stream) {
  auto kernel = tiny_stream_kernel<kNorm, kRope>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(m, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The "stream" route: R groups of T <= 16 frames, head dim 72; q, k and v
// are the column views of qkv [R, T, 3*H*72] that `maps` describe
// (ops/attention.py:stream_tma_maps over [1, R*T, H, 72]); `grid` blocks of
// `per_block` stages each and `smem_bytes` of dynamic shared memory
// (ops/tiny_attention.py:tiny_stream_geometry).
extern "C" int mc_tiny_stream(const void* q, const void* k, const void* v,
                              const long long* maps, void* out, const void* qg,
                              const void* kg, const void* cos, const void* sin, int R,
                              int T, int H, float q_scale, float eps, int grid,
                              int per_block, int smem_bytes, void* stream) {
  StreamMaps m;
  const int err = stream_ring::encode_maps(&m, q, k, v, maps);
  if (err) return err;
  StreamArgs a{};
  a.out = static_cast<bf16*>(out);
  a.qg = static_cast<const float*>(qg);
  a.kg = static_cast<const float*>(kg);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.T = T;
  a.H = H;
  a.gpb = R;
  a.n_stages = R * ((H + kSlots - 1) / kSlots);
  a.per_block = per_block;
  a.q_scale = q_scale;
  a.inv_d = 1.f / kD;
  a.eps = eps;
  if (T > kRows || (long long)grid * per_block < a.n_stages) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qg != nullptr)
    return cos != nullptr ? launch_stream<true, true>(m, a, grid, smem_bytes, st)
                          : launch_stream<true, false>(m, a, grid, smem_bytes, st);
  return cos != nullptr ? launch_stream<false, true>(m, a, grid, smem_bytes, st)
                        : launch_stream<false, false>(m, a, grid, smem_bytes, st);
}

// The "general" route: any T <= 32, D a multiple of 8 up to 128.
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
