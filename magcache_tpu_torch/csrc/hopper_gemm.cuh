// One warp-specialised GEMM body for Hopper (sm_90a), built from the parts
// of hopper_attention.cuh: out = epilogue(A @ W^T) with A [B, S, K] and W an
// nn.Linear weight [N, K], both bf16 and K-contiguous. Instantiated by
// stdit3_kernels.cu for K7 (lnmod_matmul: on the LayerNorm-modulated
// operand, bias or bias + tanh-gelu), for K6's two projections (bias;
// bias + residual) and for K8 (matmul_gated_residual: bias, gate [+
// residual]).
//
// Block: 288 threads. Warps 0-7 are two consumer warpgroups (64 output rows
// each), warp 8 the producer: one thread issues TMA copies of A and W
// k-tiles (64 columns, 128-byte swizzle) into a ring of kGemmStages stages,
// each behind a "full" mbarrier (the copies' bytes) and an "empty" one (the
// 8 consumer warps). A consumer runs wgmma m64n192k16, keeps one k-tile's
// group in flight (wait_group 1) and releases a stage once the group that
// read it is complete. Blocks are persistent, one on each SM walking output
// tiles, the ring running on from tile to tile: the producer loads the next
// tile's k-tiles while the consumers run the epilogue. Tile 128 x 192: each
// W tile serves 128 rows, and 192 divides every STDiT3 width (1152, 3456,
// 4608). The f32 accumulator is 96 registers; without setmaxnreg a
// 288-thread block may give each thread up to 224 (hopper_attention_kernel's
// 384 threads are held to 168), so the body needs no register juggling.
//
// Epilogue: the consumers write their f32 + bias [+ gelu | + residual |
// gate [+ residual]] values, rounded once at the store, into 64-column boxes of shared memory (128-byte
// swizzle: the quads' 4-byte writes hit 32 banks) and one thread stores
// them with TMA; the residual tile is copied in by TMA into the same boxes
// while the tile's products run. Stores (and residual loads) of 4 bytes
// straight from the fragments would cost a third of a projection's time.
//
// Row geometry: A's tensor map is 3-D (K, S, B) with the true S extent, and
// a tile's 128 rows stay inside one batch row b: output row (b, s), s <
// rows_out, reads A row (b, s) when s < S; rows at or past S arrive as zeros
// from the copy engine and are written as zeros. Columns past K arrive as
// zeros in A and W, so a ragged last k-tile adds nothing. The output map's
// extents (rows_out, N) clip the stores of a ragged last tile.
//
// K7 runs this body on its modulated operand, which layer_norm_kernel's
// operand epilogue (prologue.cu) writes in one pass over x. Modulating the A tiles
// inside the GEMM would redo the work for each of the N / 192 column tiles
// that read a row tile (18 to 24 at STDiT3's widths): about 10 instructions
// and 1.5 bf16 conversions an element, as much issue time as the tile's
// wgmma (both in-kernel forms, in shared memory and in registers, ran
// 1.8-2.5x the plain GEMM's time; PERF.md). The separate pass adds
// 2 x B*S*K bf16 of device-memory traffic, about 7% of K7's time at 720p.

#pragma once

#include "hopper_attention.cuh"

namespace hopper {

constexpr int kGemmBM = 128;
constexpr int kGemmBN = 192;
constexpr int kGemmBK = 64;                              // 128 bytes of bf16
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 288;
constexpr int kGemmABytes = kGemmBM * kGemmBK * 2;       // 16 KB
constexpr int kGemmWBytes = kGemmBN * kGemmBK * 2;       // 24 KB
constexpr int kGemmStage = kGemmABytes + kGemmWBytes;    // 40 KB, 1,024-aligned
constexpr int kGemmOutBox = 64 * 128;                    // 64 rows x 64 bf16, swizzled
constexpr int kGemmOut = kGemmStages * kGemmStage;       // output staging: 2 consumers
                                                         // x 3 boxes
constexpr int kGemmBars = kGemmOut + 2 * 3 * kGemmOutBox;
constexpr int kGemmSmem = kGemmBars + (2 * kGemmStages + 2) * 8 + 1024;

// the numbering of the C entry points' `epi`
enum Epilogue { kEpiBias = 0, kEpiGelu = 1, kEpiResid = 2, kEpiGate = 3, kEpiGateResid = 4 };

__host__ __device__ constexpr bool epi_has_resid(int epi) {
  return epi == kEpiResid || epi == kEpiGateResid;
}
__host__ __device__ constexpr bool epi_has_gate(int epi) {
  return epi == kEpiGate || epi == kEpiGateResid;
}

struct GemmMaps {
  CUtensorMap a;        // A: (K, S, B), box (64, 128, 1)
  CUtensorMap w;        // W: (K, N), box (64, 192)
  CUtensorMap o;        // out: (N, rows_out, B), box (64, 64, 1)
  CUtensorMap r;        // with a residual: its map, the output's geometry
};

struct GemmArgs {
  const float* bias;    // [N]
  const float* gate;    // kEpiGate*: f32 rows of N; row (b, s) takes b / rep + s / span
  int B, S, rows_out, K, N;
  int m_tiles;          // row tiles per batch row
  int rep, span;        // kEpiGate*
};

// A 3-D TMA store from shared memory; the box's parts past the map's
// extents are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The tanh-approximated GELU in f32 with tanh(u) = 1 - 2 / (exp(2u) + 1):
// within 1e-6 of tanhf, a small fraction of a bf16 ulp, at a fifth of its
// instructions.
__device__ __forceinline__ float gelu_tanh_fast(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (2.f - __fdividef(2.f, __expf(2.f * u) + 1.f));
}

// d[96] (+)= A[64x16] B[16x192], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <int kEpi>
__global__ void __launch_bounds__(kGemmThreads, 1)
hopper_gemm_kernel(const __grid_constant__ GemmMaps maps, const GemmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmBars);
  uint64_t* empty = full + kGemmStages;
  uint64_t* resid_full = empty + kGemmStages;   // residual: its tile landed
  uint64_t* out_free = resid_full + 1;          // residual: both consumers' stores read
  constexpr bool kResid = epi_has_resid(kEpi), kGate = epi_has_gate(kEpi);

  // Persistent: block x takes tiles x, x + gridDim.x, ...; a tile's N index
  // runs fastest, so that the tiles in flight share their A tiles in L2.
  const int n_tiles = (a.N + kGemmBN - 1) / kGemmBN;
  const int tiles = n_tiles * a.B * a.m_tiles;
  const int nk = (a.K + kGemmBK - 1) / kGemmBK;
  auto coords = [&](int tile, int& n0, int& b, int& s0) {
    n0 = (tile % n_tiles) * kGemmBN;
    b = tile / n_tiles / a.m_tiles;
    s0 = (tile / n_tiles % a.m_tiles) * kGemmBM;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(resid_full, 1);
    mbar_init(out_free, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: the k-tiles of every tile of this block, through one ring ----
    if (lane == 0) {
      int s = 0, phase = 0, it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        int n0, b, s0;
        coords(tile, n0, b, s0);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = smem + s * kGemmStage;
          mbar_expect_tx(&full[s], kGemmStage);
          tma_load_3d(st, &maps.a, &full[s], kt * kGemmBK, s0, b);
          tma_load_2d(st + kGemmABytes, &maps.w, &full[s], kt * kGemmBK, n0);
          if (++s == kGemmStages) {
            s = 0;
            phase ^= 1;
          }
          if (kResid && kt == min(nk, kGemmStages) - 1) {
            // the residual tile, into the output staging boxes it is added
            // in, once the previous tile's stores have read them (the ring
            // is full of this tile's k-tiles by then)
            mbar_wait(out_free, (it & 1) ^ 1);
            mbar_expect_tx(resid_full, 2 * 3 * kGemmOutBox);
            for (int h = 0; h < 2; ++h)
              for (int box = 0; box < 3; ++box)
                tma_load_3d(smem + kGemmOut + (h * 3 + box) * kGemmOutBox, &maps.r,
                            resid_full, n0 + 64 * box, s0 + 64 * h, b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int c = warp / 4;                    // rows 64c..64c+63 of a tile
  const int ct = threadIdx.x % 128;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t base = smem_addr(smem);
  unsigned char* out_tile = smem + kGemmOut + c * 3 * kGemmOutBox;
  float acc[96];
  int s = 0, phase = 0, it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    int n0, b, s0;
    coords(tile, n0, b, s0);
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[s], phase);
      const uint64_t da = smem_desc(base + s * kGemmStage + c * 64 * 128, 16, 8 * 128, 128);
      const uint64_t dw = smem_desc(base + s * kGemmStage + kGemmABytes, 16, 8 * 128, 128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk)
        wgmma_ss_n192(acc, desc_add(da, 2 * kk), desc_add(dw, 2 * kk));
      wgmma_commit();
      wgmma_wait1();                           // k-tile kt - 1 is complete
      fence_regs(acc);
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == kGemmStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait0();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);  // the ring runs on into the next tile

    // Epilogue: f32 + bias [, gelu | + residual | rounded, * gate [,
    // rounded, + residual]], one rounding at the store, into three
    // 64-column boxes of shared memory (128-byte swizzle, so the quads'
    // 4-byte writes hit 32 banks), then TMA stores: the map's extents drop
    // the rows past rows_out and the columns past N. Rows at or past S are
    // zeros. acc[i]: row 16w + g + 8((i >> 1) & 1) of the consumer's 64,
    // column 8(i >> 2) + 2t + (i & 1). The producer loads the next tiles'
    // k-tiles meanwhile.
    if constexpr (kResid) mbar_wait(resid_full, it & 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = (warp % 4) * 16 + g + 8 * r;
      const int srow = s0 + c * 64 + rl;
      const bool live = srow < a.S;
      const float* grow = nullptr;
      if constexpr (kGate)
        grow = a.gate + (size_t)(b / a.rep + (live ? srow : 0) / a.span) * a.N;
#pragma unroll
      for (int i = 0; i < 96; ++i) {
        if (((i >> 1) & 1) != r || (i & 1)) continue;
        const int nl = 8 * (i >> 2) + 2 * t, n = n0 + nl;
        const int cb = nl & 63;
        uint32_t* cell = reinterpret_cast<uint32_t*>(
            out_tile + (nl >> 6) * kGemmOutBox + rl * 128 + (((cb >> 3) ^ (rl & 7)) << 4) +
            (cb & 7) * 2);
        float v0 = 0.f, v1 = 0.f;
        if (live && n < a.N) {
          const float2 bb = *reinterpret_cast<const float2*>(a.bias + n);
          v0 = acc[i] + bb.x;
          v1 = acc[i + 1] + bb.y;
          if constexpr (kEpi == kEpiGelu) {
            v0 = gelu_tanh_fast(v0);
            v1 = gelu_tanh_fast(v1);
          }
          if constexpr (kGate) {
            const float2 gg = __ldg(reinterpret_cast<const float2*>(grow + n));
            v0 = mc::round_bf16(v0) * gg.x;
            v1 = mc::round_bf16(v1) * gg.y;
            if constexpr (kResid) {
              v0 = mc::round_bf16(v0);
              v1 = mc::round_bf16(v1);
            }
          }
          if constexpr (kResid) {
            const float2 x = mc::unpack_bf16(*cell);
            v0 += x.x;
            v1 += x.y;
          }
        }
        *cell = pack_bf16(v0, v1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + c, 128);
    if (ct == 0) {
#pragma unroll
      for (int box = 0; box < 3; ++box)
        if (n0 + 64 * box < a.N)
          tma_store_3d(&maps.o, out_tile + box * kGemmOutBox, n0 + 64 * box, s0 + 64 * c, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the boxes are written again for the next tile: wait until read
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if constexpr (kResid) mbar_arrive(out_free);
    }
    bar_sync(1 + c, 128);
  }
}

// Encodes the maps (A, W, out and, with a residual, the residual's;
// `words`: 3 or 4 x kMapWords) and launches the instantiation, one block on
// each SM (or one a tile, when there are fewer tiles).
template <int kEpi>
int launch_gemm(const void* x, const void* w, void* out, const void* resid,
                const long long* words, const GemmArgs& a, cudaStream_t stream) {
  GemmMaps maps;
  int err = encode_map(&maps.a, x, words);
  if (!err) err = encode_map(&maps.w, w, words + kMapWords);
  if (!err) err = encode_map(&maps.o, out, words + 2 * kMapWords);
  if (!err && epi_has_resid(kEpi)) err = encode_map(&maps.r, resid, words + 3 * kMapWords);
  if (err) return err;
  auto kernel = hopper_gemm_kernel<kEpi>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (e != cudaSuccess) return (int)e;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long tiles = (long long)((a.N + kGemmBN - 1) / kGemmBN) * a.B * a.m_tiles;
  kernel<<<(int)(tiles < sms ? tiles : sms), kGemmThreads, kGemmSmem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace hopper
