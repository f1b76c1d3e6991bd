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
// Design.  A block owns a 128 x 128 output tile and walks K in steps of 64
// with cp.async double buffering, zero-filled past the edges.  The
// m16n8k32 s8 mma.sync wants both operands K-contiguous: x is, but y is
// (K, N) row-major and ldmatrix's .trans works on 16-bit elements only, so
// it cannot transpose bytes.  So each K step lands y's (64, 128) tile as it
// is stored, and the block then transposes it in shared memory into a
// (128, 64) n-major tile with byte permutes (prmt: one 4 x 4 byte block per
// thread and pass), from which ldmatrix reads the B fragments; no extra pass
// over device memory and no copy of y.  Eight warps, 2 along M x 4 along N,
// each own 64 x 32 of the tile in int32 registers, written once at the end.
// wgmma's s8 path, TMA and a deeper pipeline are later work.  The TPU
// kernel's 512^3 VMEM blocks are not carried over: the wrapper keeps the
// reference's bm/bn/bk only as a validity check.
//
// Any shape.  When K and N are multiples of 16 and both operands are 16-byte
// aligned, every 16-byte chunk of a row is aligned and the tiles land by
// cp.async (zero-filled past the edges) and the result leaves in 8-byte
// pairs.  Otherwise (ragged K or N, or an operand at an odd address) the
// same kernel, instantiated with kVec = false, lands each chunk through
// registers with byte loads, zero past the edges, and stores the result
// element by element; the arithmetic is the same.
//
// Contract: x (M, K) and y (K, N) int8 contiguous, out (M, N) int32
// allocated by the caller, 4-byte aligned.  The kernel allocates nothing
// and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // K per step
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N, 64x32 each
constexpr int A_LD = BK + 16;  // 80-byte pitch: conflict-free ldmatrix
constexpr int B_LD = BN + 16;  // 144-byte pitch of the tile of y as loaded
constexpr int T_LD = BK + 16;  // 80-byte pitch of the transposed tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; copies zeros when `pred` is false (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y,
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

  // Each thread copies two 16-byte chunks of each operand per K step.
  // kVec: by cp.async, whole chunks (K, N % 16 == 0: a chunk is wholly in
  // or out).  Otherwise byte by byte through registers, zero past the
  // edges, and one 16-byte store into shared memory.
  auto load_stage = [&](int stage, int it) {
    const int k0 = it * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, kc = (c & 3) * 16;  // x: 128 rows x 4 chunks
      const bool in_m = m0 + row < M;
      if constexpr (kVec) {
        const bool ok = in_m && k0 + kc < K;
        const int8_t* src = ok ? x + (m0 + row) * K + k0 + kc : x;
        cp_async16(smem_addr(&sA[stage][row][kc]), src, ok);
      } else {
        const int8_t* src = x + (m0 + row) * K + k0 + kc;
        const int n = in_m ? min(16, K - (k0 + kc)) : 0;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (b < n) v[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b & 3));
        *reinterpret_cast<uint4*>(&sA[stage][row][kc]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int krow = c >> 3, nc = (c & 7) * 16;  // y: 64 k-rows x 8 chunks
      const bool in_k = k0 + krow < K;
      if constexpr (kVec) {
        const bool ok = in_k && n0 + nc < N;
        const int8_t* src = ok ? y + static_cast<long long>(k0 + krow) * N + n0 + nc : y;
        cp_async16(smem_addr(&sB[stage][krow][nc]), src, ok);
      } else {
        const int8_t* src = y + static_cast<long long>(k0 + krow) * N + n0 + nc;
        const int n = in_k ? min(16, N - (n0 + nc)) : 0;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (b < n) v[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b & 3));
        *reinterpret_cast<uint4*>(&sB[stage][krow][nc]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
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
  cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    // stage `it` has landed for every thread, and every thread is done with
    // step it-1 (its reads of sA[st ^ 1], sB[st ^ 1] and sT)
    __syncthreads();
    if (it + 1 < iters) load_stage(st ^ 1, it + 1);
    cp_async_commit();
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
        ldmatrix_x4(af[mi], smem_addr(&sA[st][row][col]));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n-tile 2nj, k lo), (2nj, k hi), (2nj+1, k lo), (2nj+1, k hi)
        const int nrow = wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk + ((lane >> 3) & 1) * 16;
        ldmatrix_x4(bfm[nj], smem_addr(&sT[nrow][col]));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8_16832(acc[mi][ni], af[mi], bfm[ni >> 1][(ni & 1) * 2],
                       bfm[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

  // Epilogue: kVec stores one 8-byte pair per accumulator pair (N % 16 == 0,
  // so a pair is wholly in or out); otherwise element by element.  Ragged M
  // and N edges are masked here.
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
        if constexpr (kVec) {
          *reinterpret_cast<int2*>(out + m * N + col) =
              make_int2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
        } else {
          out[m * N + col] = acc[mi][ni][half * 2];
          if (col + 1 < N) out[m * N + col + 1] = acc[mi][ni][half * 2 + 1];
        }
      }
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const void* x, const void* y, void* out, int M, int N, int K,
                                  void* stream) {
  const long long row_tiles = (static_cast<long long>(M) + BM - 1) / BM;
  const int col_tiles = (N + BN - 1) / BN;
  if (M <= 0 || N <= 0 || K <= 0 || row_tiles > 65535 || col_tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_tiles));
  const bool vec = K % 16 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  auto kernel = vec ? int8_matmul_kernel<true> : int8_matmul_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(y), static_cast<int32_t*>(out),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}
