// Blocked (M, K) int8 x (K, N) int8 -> (M, N) int32 matrix product --
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel braintpu/ops/int8_probe.py::int8_matmul (body
// `_kernel`), which computes out[m, n] = sum_k x[m, k] * y[k, n] exactly in
// int32: an int32 accumulator zeroed at the first K step and flushed at the
// last.  It is a throughput probe with no production caller; its entry point
// is braintpu_torch/tools/probe.py.  Python wrapper:
// braintpu_torch/ops/int8_probe.py.
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s HBM).  The probe's
// square shape, 4096^3, does 2*4096^3 = 137 G operations on 16 + 16 + 64 MiB
// of operands and result: 0.069 ms of int8 tensor-core time against 0.030 ms
// of memory time, so it is bound by operations.  The stage-GEMM shapes
// ((3072, 384, 128), (3072, 1152, 256), (1536, 1152, 384)) need 0.3-1.8 G
// operations and move 2.8-6.9 MB, under 2.1 microseconds of either: they
// are bound by bytes on paper (the int32 result dominates) and by launch
// latency in practice.
//
// Fast path (K % 16 == 0, N % 16 == 0, both operands 16-byte aligned: TMA
// needs 16-byte row strides and addresses).  Two launches:
//   1. int8_transpose_kernel writes y^T (N, K) into scratch the wrapper
//      allocates: 64 x 64 byte tiles through shared memory, 16-byte loads
//      and stores, 2*K*N bytes (32 MiB at 4096^2, ~0.01 ms at 3.35 TB/s).
//   2. int8_wgmma_kernel, a persistent warp-specialised GEMM: one producer
//      thread keeps a ring of 4 stages of (128 x 128-byte A tile, 256 x
//      128-byte B tile) full by TMA (128-byte swizzle, zeros past the
//      edges), full/empty mbarriers; two consumer warpgroups each own 64
//      rows x 256 columns of the 128 x 256 output tile in int32 registers
//      and issue wgmma m64n256k32 .s32.s8.s8 from shared memory, one K
//      step's products in flight while they wait for the next tile; the
//      block walks its output tiles with a static stride, so the next
//      tile's loads overlap this tile's epilogue (int32 pairs straight to
//      global memory, ragged M and N masked).
// Why the transpose (and not out^T = y^T x^T with y as a register
// operand): an 8-bit wgmma takes both shared-memory operands K-major only
// (the descriptor's transpose bit exists for 16-bit types), and y is
// (K, N) N-major.  A separate pass costs 2*K*N bytes, about a tenth of
// the GEMM at 4096^3, and keeps the GEMM a plain SS loop; the register
// route would assemble every B fragment with byte permutes in the
// consumers' critical path.  The timed call includes the transpose.
//
// Byte path (every other valid call: ragged K or N, or an operand at an
// odd address): int8_bytes_kernel, 128 x 128 tiles walked in K steps of 64,
// each 16-byte chunk landed through registers with byte loads and zero
// fill, y's tile transposed in shared memory with byte permutes (prmt),
// m16n8k32 s8 mma.sync, the result stored element by element.  It is a
// kernel of its own, not a fallback: the wrapper routes by the rule above,
// and both routes count as a launch of int8_matmul.
//
// Contract: x (M, K) and y (K, N) int8 contiguous, out (M, N) int32
// allocated by the caller, 4-byte aligned; yt (N, K) int8 scratch for the
// fast path, null for the byte path.  The kernels allocate nothing and run
// on the caller's stream.

#include "conv3d_wgmma.cuh"
#include <stdint.h>

namespace {

using conv3d_wgmma::desc_a;
using conv3d_wgmma::mbar_arrive;
using conv3d_wgmma::mbar_expect_tx;
using conv3d_wgmma::mbar_init;
using conv3d_wgmma::mbar_wait;
using conv3d_wgmma::smem_u32;
using conv3d_wgmma::tma_load_2d;
using conv3d_wgmma::wgmma_commit;
using conv3d_wgmma::wgmma_fence;
using conv3d_wgmma::wgmma_wait;

// ---------------------------------------------------------------------------
// Fast path: transpose, then the wgmma GEMM
// ---------------------------------------------------------------------------

constexpr int T_TILE = 64;   // transpose tile: 64 x 64 bytes
constexpr int T_LDT = 68;    // shared pitch: 4-byte rows, 2-way conflicts at worst

// y (K, N) -> yt (N, K); K % 16 == 0 and N % 16 == 0, so a 16-byte chunk is
// wholly in or out.
__global__ void __launch_bounds__(256)
int8_transpose_kernel(const int8_t* __restrict__ y, int8_t* __restrict__ yt, int K, int N) {
  __shared__ __align__(16) uint8_t t[T_TILE][T_LDT];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.y * T_TILE, n0 = blockIdx.x * T_TILE;
  const int r = tid >> 2, c = (tid & 3) * 16;
  if (k0 + r < K && n0 + c < N) {
    const uint4 v = *reinterpret_cast<const uint4*>(y + static_cast<long long>(k0 + r) * N + n0 + c);
    uint32_t* dst = reinterpret_cast<uint32_t*>(&t[r][c]);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  }
  __syncthreads();
  // thread: output row n0 + r, bytes k0 + c .. + 15
  if (n0 + r < N && k0 + c < K) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = static_cast<uint32_t>(t[c + 4 * q][r]) | static_cast<uint32_t>(t[c + 4 * q + 1][r]) << 8 |
             static_cast<uint32_t>(t[c + 4 * q + 2][r]) << 16 |
             static_cast<uint32_t>(t[c + 4 * q + 3][r]) << 24;
    }
    *reinterpret_cast<uint4*>(yt + static_cast<long long>(n0 + r) * K + k0 + c) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

constexpr int G_BM = 128;      // output rows per tile: two consumer warpgroups
constexpr int G_BN = 256;      // output columns per tile
constexpr int G_BK = 128;      // bytes of K per stage: one 128-byte swizzle row
constexpr int G_STAGES = 4;
constexpr int G_A = G_BM * G_BK;  // 16 KiB
constexpr int G_B = G_BN * G_BK;  // 32 KiB
constexpr int G_THREADS = 384;
constexpr int G_SMEM = 1024 + G_STAGES * (G_A + G_B) + 2 * G_STAGES * 8;

// wgmma m64nNk32 s8 x s8 -> s32 (N = 256 here), both operands K-major
// from shared memory; scale_d = 0 overwrites the accumulators, 1 adds.
template <int N>
__device__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
      "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
      "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
      "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
      "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
      "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
      "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
      "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
      "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
      "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
      "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
      "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
      "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(G_THREADS, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap my,
                      int32_t* __restrict__ out, int M, int N, int K, int tiles_m, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem;
  uint8_t* sB = smem + G_STAGES * G_A;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + G_STAGES * G_B);
  uint64_t* empty = full + G_STAGES;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int ksteps = (K + G_BK - 1) / G_BK;

  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, tile after tile ----------
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % tiles_m) * G_BM, n0 = (t / tiles_m) * G_BN;
        for (int kb = 0; kb < ksteps; ++kb) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t fb = smem_u32(&full[stage]);
          mbar_expect_tx(fb, G_A + G_B);
          tma_load_2d(smem_u32(sA + stage * G_A), &mx, fb, kb * G_BK, m0);
          tma_load_2d(smem_u32(sB + stage * G_B), &my, fb, kb * G_BK, n0);
          if (++stage == G_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows [64c, 64c + 64) of each tile ---------
  const int c = wg - 1;
  const int warp = (tid & 127) >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[G_BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * G_BM, n0 = (t / tiles_m) * G_BN;
    int prev = 0;
    for (int kb = 0; kb < ksteps; ++kb) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t a = smem_u32(sA + stage * G_A + c * 64 * G_BK);
      const uint32_t b = smem_u32(sB + stage * G_B);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_BK / 32; ++kk)
        wgmma_s8<G_BN>(acc, desc_a(a + kk * 32), desc_a(b + kk * 32), kb > 0 || kk > 0);
      wgmma_commit();
      // keep this step's products in flight; the previous step's are done
      if (kb > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));
      }
      prev = stage;
      if (++stage == G_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));
    // acc[4j + 2i + e] is row 16 warp + g + 8i, column 8j + 2 t4 + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + c * 64 + warp * 16 + g + 8 * i;
      if (m >= M) continue;
      int32_t* row = out + m * N;
#pragma unroll
      for (int j = 0; j < G_BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t4;  // N % 16 == 0: a pair is wholly in or out
        if (col < N) *reinterpret_cast<int2*>(row + col) = make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// 2-D map of a (rows, K) int8 matrix, K contiguous: box 128 bytes x
// box_rows, 128-byte swizzle, zeros past the edges.
bool encode_kmajor(CUtensorMap* m, const void* p, int rows, int K, int box_rows) {
  conv3d_wgmma::EncodeTiledFn fn = conv3d_wgmma::encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)K};
  cuuint32_t box[2] = {(cuuint32_t)G_BK, (cuuint32_t)box_rows};
  cuuint32_t one[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Byte path: ragged K or N, or an operand at an odd address
// ---------------------------------------------------------------------------

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // K per step
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N, 64x32 each
constexpr int A_LD = BK + 16;  // 80-byte pitch: conflict-free ldmatrix
constexpr int B_LD = BN + 16;  // 144-byte pitch of the tile of y as loaded
constexpr int T_LD = BK + 16;  // 80-byte pitch of the transposed tile

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Up to 16 bytes from src (n of them; zeros past), as one 16-byte word.
__device__ __forceinline__ uint4 load_bytes(const int8_t* src, int n) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) v[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(THREADS)
int8_bytes_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y,
                  int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[2][BM][A_LD];
  __shared__ __align__(16) int8_t sB[2][BK][B_LD];
  __shared__ __align__(16) int8_t sT[BN][T_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // warp tile rows [wm*64, wm*64+64)
  const int wn = warp >> 1;  // warp tile cols [wn*32, wn*32+32)
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int iters = (K + BK - 1) / BK;

  // Each thread lands two 16-byte chunks of each operand per K step, byte
  // by byte through registers, zero past the edges.
  auto load_stage = [&](int stage, int it) {
    const int k0 = it * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, kc = (c & 3) * 16;  // x: 128 rows x 4 chunks
      const int n = m0 + row < M ? min(16, K - (k0 + kc)) : 0;
      *reinterpret_cast<uint4*>(&sA[stage][row][kc]) = load_bytes(x + (m0 + row) * K + k0 + kc, n);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int krow = c >> 3, nc = (c & 7) * 16;  // y: 64 k-rows x 8 chunks
      const int n = k0 + krow < K ? min(16, N - (n0 + nc)) : 0;
      *reinterpret_cast<uint4*>(&sB[stage][krow][nc]) =
          load_bytes(y + static_cast<long long>(k0 + krow) * N + n0 + nc, n);
    }
  };

  // sB[stage] (k, n) -> sT (n, k): each thread moves two 4 x 4 byte blocks
  // (4 words in, 4 words out).  In a warp, 8 lanes run along n and 4 along
  // k; the 16 (warp, pass) pairs cover the 16 x 32 blocks of the tile.
  auto transpose_stage = [&](int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = warp * 2 + i;
      const int kb = (g & 3) * 4 + (lane >> 3);
      const int nb = (g >> 2) * 8 + (lane & 7);
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(&sB[stage][kb * 4 + r][nb * 4]);
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      *reinterpret_cast<uint32_t*>(&sT[nb * 4 + 0][kb * 4]) = __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<uint32_t*>(&sT[nb * 4 + 1][kb * 4]) = __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<uint32_t*>(&sT[nb * 4 + 2][kb * 4]) = __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(&sT[nb * 4 + 3][kb * 4]) = __byte_perm(t1, t3, 0x7632);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  load_stage(0, 0);
  for (int it = 0; it < iters; ++it) {
    const int st = it & 1;
    // stage `it` is stored for every thread, and every thread is done with
    // step it-1 (its reads of sA[st ^ 1], sB[st ^ 1] and sT)
    __syncthreads();
    if (it + 1 < iters) load_stage(st ^ 1, it + 1);
    transpose_stage(st);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4];
      uint32_t bfm[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 16;
        conv3d_wgmma::ldmatrix_x4(af[mi], smem_u32(&sA[st][row][col]));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n-tile 2nj, k lo), (2nj, k hi), (2nj+1, k lo), (2nj+1, k hi)
        const int nrow = wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk + ((lane >> 3) & 1) * 16;
        conv3d_wgmma::ldmatrix_x4(bfm[nj], smem_u32(&sT[nrow][col]));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8_16832(acc[mi][ni], af[mi], bfm[ni >> 1][(ni & 1) * 2],
                       bfm[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

  // Epilogue: element by element, ragged M and N edges masked.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
        if (m >= M) continue;
        out[m * N + col] = acc[mi][ni][half * 2];
        if (col + 1 < N) out[m * N + col + 1] = acc[mi][ni][half * 2 + 1];
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an integer handle).  With
// `yt` (N * K bytes of scratch) the fast path: the transpose, then the
// wgmma GEMM on `grid` persistent blocks (at most one per output tile);
// its conditions unmet, cudaErrorInvalidValue.  With a null `yt` the byte
// path.  Returns the first launch error as an int, 0 when all launches
// were accepted.
extern "C" int int8_matmul_launch(const void* x, const void* y, void* out, int M, int N, int K,
                                  void* yt, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (yt == nullptr) {
    const long long row_tiles = (static_cast<long long>(M) + BM - 1) / BM;
    const int col_tiles = (N + BN - 1) / BN;
    if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    int8_bytes_kernel<<<dim3(col_tiles, static_cast<unsigned>(row_tiles)), THREADS, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(y), static_cast<int32_t*>(out),
        M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(yt);
  const long long tiles_m = (static_cast<long long>(M) + G_BM - 1) / G_BM;
  const long long tiles = tiles_m * ((N + G_BN - 1) / G_BN);
  if (K % 16 || N % 16 || align % 16 || (K + T_TILE - 1) / T_TILE > 65535 || tiles > 0x7fffffffLL ||
      grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, my;
  if (!encode_kmajor(&mx, x, M, K, G_BM) || !encode_kmajor(&my, yt, N, K, G_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  int8_transpose_kernel<<<dim3((N + T_TILE - 1) / T_TILE, (K + T_TILE - 1) / T_TILE), 256, 0, s>>>(
      static_cast<const int8_t*>(y), static_cast<int8_t*>(yt), K, N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool raised = false;  // the shared-memory limit, raised on the first launch only
  if (!raised) {
    const cudaError_t ea = cudaFuncSetAttribute(
        int8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (ea != cudaSuccess) return static_cast<int>(ea);
    raised = true;
  }
  int8_wgmma_kernel<<<grid, G_THREADS, G_SMEM, s>>>(mx, my, static_cast<int32_t*>(out), M, N, K,
                                                   static_cast<int>(tiles_m),
                                                   static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
