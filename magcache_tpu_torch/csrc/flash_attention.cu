// K1: flash attention forward on the DiT activation layout [B, S, H, D], bf16.
//
// Replaces the TPU kernel magcache_tpu/ops/attention.py:flash_attention_bshd
// (Pallas bodies _flash_kernel_bshd_fixed_max and _flash_kernel_bshd).
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
// Plain C interface, loaded from Python with ctypes; the wrapper checks
// shapes, dtypes and contiguity, allocates the output and passes pointers
// and PyTorch's current stream. The launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockM = 64;                 // query rows per block, 16 per warp
constexpr int kBlockN = 64;                 // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kHeadDim + 8;       // padded smem row, bf16 elements
constexpr int kChunksPerRow = kHeadDim / 8; // 16-byte chunks per row
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes =
    (size_t)(kBlockM + 2 * kBlockN) * kStride * sizeof(__nv_bfloat16);

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8, f32] += a[16x16, bf16, row] * b[16x8, bf16, col]
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Copy kBlockN rows of one head, starting at row0, into a padded smem tile.
// Rows at or past `limit` are zero-filled.
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             size_t row_stride, int row0,
                                             int limit) {
  for (int c = threadIdx.x; c < kBlockN * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * kStride + col) = val;
  }
}

template <bool kFixedMax>
__global__ void __launch_bounds__(kThreads)
flash_attention_bshd_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int Sq, int Skv,
                            int H, int kv_len, float q_scale, float m_const) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBlockM * kStride;
  __nv_bfloat16* Vs = Ks + kBlockN * kStride;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBlockM;
  const size_t row_stride = (size_t)H * kHeadDim;
  const __nv_bfloat16* qh = q + (size_t)b * Sq * row_stride + (size_t)h * kHeadDim;
  const __nv_bfloat16* kh = k + (size_t)b * Skv * row_stride + (size_t)h * kHeadDim;
  const __nv_bfloat16* vh = v + (size_t)b * Skv * row_stride + (size_t)h * kHeadDim;
  __nv_bfloat16* oh = o + (size_t)b * Sq * row_stride + (size_t)h * kHeadDim;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;     // mma group: accumulator rows g and g + 8
  const int t = lane & 3;      // thread in group: accumulator cols 2t, 2t + 1
  const int wr = warp * 16;    // this warp's first row in the Q tile

  // Q tile, scaled by scale*log2(e) and rounded to bf16; rows past Sq are 0.
  for (int c = threadIdx.x; c < kBlockM * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) {
      val = *reinterpret_cast<const uint4*>(qh + (size_t)(q0 + r) * row_stride + col);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * q_scale);
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
    load_kv_tile(Ks, kh, row_stride, k0, kv_len);
    load_kv_tile(Vs, vh, row_stride, k0, kv_len);
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
    if (k0 + kBlockN > kv_len) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + t * 2 + (e & 1) >= kv_len) s[nt][e] = kNegInf;
    }

    if (kFixedMax) {
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
      *reinterpret_cast<uint32_t*>(oh + (size_t)r0 * row_stride + col) =
          pack_bf16(acc[nt][0] / l_run[0], acc[nt][1] / l_run[0]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r1 * row_stride + col) =
          pack_bf16(acc[nt][2] / l_run[1], acc[nt][3] / l_run[1]);
  }
}

template <bool kFixedMax>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int kv_len, float q_scale, float m_const,
           cudaStream_t stream) {
  auto kernel = flash_attention_bshd_kernel<kFixedMax>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, H, kv_len, q_scale, m_const);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mc_flash_attention_bshd(const void* q, const void* k,
                                       const void* v, void* o, int B, int Sq,
                                       int Skv, int H, int kv_len,
                                       float q_scale, int fixed_max,
                                       float m_const, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fixed_max)
    return launch<true>(q, k, v, o, B, Sq, Skv, H, kv_len, q_scale, m_const, st);
  return launch<false>(q, k, v, o, B, Sq, Skv, H, kv_len, q_scale, m_const, st);
}

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
