// 2x2x2 stride-2 transposed convolution without bias on NDHWC bf16, f32
// accumulation, bf16 output, the pixel shuffle written by the epilogue --
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel braintpu/ops/upconv_pallas.py::upconv2x (bodies
// `_kernel` and `_kernel_lanes`), which computes the same function:
//   out[n, 2d+kd, 2h+kh, 2w+kw, c] = sum_ci x[n, d, h, w, ci] * w[ci, kd, kh, kw, c].
// Python wrapper: braintpu_torch/ops/upconv.py.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s HBM).  Per input
// voxel the kernel does 2*ci*8*co flops and moves 2*ci bytes in and
// 16*co bytes out: 2*8*ci*co / (2*ci + 16*co) < ci flops/byte, below the
// card's ~295 for every up-conv of the two models (ci <= 320), so it is
// bytes-bound, mostly by the output, which has 8x the input's voxels.  At
// the level-0 up-conv of a 224x224x128 forward of the GroupNorm model
// (112x112x64x64 -> 224x224x128x64) that is 0.92 GB, 0.27 ms at 3.35 TB/s.
// The design therefore writes each output byte once, in 16-byte runs, and
// lets no shuffle pass touch device memory.
//
// Design.  A GEMM with M = N*D*H*W input voxels, K = ci, N = 8*co whose
// column j = ((kd*2 + kh)*2 + kw)*co + c.  A block owns 128 rows x 64
// columns, walks K in chunks of 32 with cp.async double buffering into
// shared memory (zero-filled past the edges) and runs bf16 mma.sync
// m16n8k16 into f32 registers, as conv3d_tap_merged.cu does.  Column tiles
// vary fastest in the grid, so the blocks that share an input tile run
// together and find it in L2.  For a fixed (kd, kh) the 2*co columns
// (kw, c) of a row are one contiguous run of the output at
// (n, 2d+kd, 2h+kh, 2w, 0) -- the reference's "lanes" layout -- so the
// epilogue rounds the tile to bf16 in shared memory and writes each row's
// 16-byte chunks straight to their run: the pixel shuffle costs no pass.
//
// Contract (checked by the wrapper): x (N,D,H,W,ci) bf16 contiguous,
// w (ci,2,2,2,co) bf16 contiguous (read as (ci, 8*co)), y (N,2D,2H,2W,co)
// bf16 allocated by the caller; ci % 8 == 0, co % 8 == 0, 16-byte aligned
// pointers.  The kernel allocates nothing and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // input voxels (GEMM rows) per block
constexpr int BN = 64;         // GEMM columns per block
constexpr int BK = 32;         // input channels per K step
constexpr int THREADS = 256;   // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int A_LD = BK + 8;   // 80-byte row pitch: conflict-free ldmatrix
constexpr int B_LD = BN + 8;   // 144-byte row pitch
constexpr int C_LD = BN + 8;   // epilogue tile pitch (reuses sA)
static_assert(BM * C_LD <= 2 * BM * A_LD, "epilogue tile must fit in the A buffers");

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

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
upconv2x_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ y, int D, int H, int W, int ci, int co,
                long long M, int col_tiles) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BK][B_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int ncols = 8 * co;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const long long m0 = static_cast<long long>(blockIdx.x / col_tiles) * BM;

  // A tile: BM rows x 4 chunks of 8 channels, 2 chunks per thread.
  const int a_kc = tid & 3;
  int a_row[2];
  bool a_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a_row[j] = (tid >> 2) + j * (THREADS / 4);
    a_ok[j] = m0 + a_row[j] < M;
  }
  // B tile: BK rows x 8 chunks of 8 columns, one chunk per thread.
  const int b_k = tid >> 3;
  const int b_c = (tid & 7) * 8;
  const bool b_col_ok = (n0 + b_c) < ncols;

  const int iters = (ci + BK - 1) / BK;
  auto load_stage = [&](int stage, int it) {
    const int c0 = it * BK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + a_kc * 8;
      const bool ok = a_ok[j] && c < ci;
      const __nv_bfloat16* src = ok ? x + (m0 + a_row[j]) * ci + c : x;
      cp_async16(smem_addr(&sA[stage][a_row[j]][a_kc * 8]), src, ok);
    }
    const int k = c0 + b_k;
    const bool okb = b_col_ok && k < ci;
    const __nv_bfloat16* srcb = okb ? w + static_cast<long long>(k) * ncols + n0 + b_c : w;
    cp_async16(smem_addr(&sB[stage][b_k][b_c]), srcb, okb);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) load_stage((it + 1) & 1, it + 1);
    cp_async_commit();  // possibly empty group keeps the wait count uniform
    cp_async_wait_1();
    __syncthreads();
    const int st = it & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
      uint32_t bfm[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm * 32 + mi * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[mi], smem_addr(&sA[st][row][col]));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ncol = wn * 32 + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bfm[nj], smem_addr(&sB[st][krow][ncol]));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bfm[ni >> 1][(ni & 1) * 2],
                         bfm[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // Epilogue: round the tile to bf16 in shared memory (the A buffers are
  // free after the last barrier), then write 16-byte chunks to their runs.
  __nv_bfloat16(*sC)[C_LD] = reinterpret_cast<__nv_bfloat16(*)[C_LD]>(&sA[0][0][0]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
        const int c = wn * 32 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(&sC[r][c]) =
            __floats2bfloat162_rn(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
  __syncthreads();
  const int run = 2 * co;  // columns per (kd, kh) phase pair
  for (int idx = tid; idx < BM * (BN / 8); idx += THREADS) {
    const int r = idx / (BN / 8);
    const int cc = (idx % (BN / 8)) * 8;
    const long long m = m0 + r;
    const int col = n0 + cc;
    if (m >= M || col >= ncols) continue;
    long long t = m;
    const int ww = static_cast<int>(t % W);
    t /= W;
    const int hh = static_cast<int>(t % H);
    t /= H;
    const int dd = static_cast<int>(t % D);
    const long long nn = t / D;
    const int ph = col / run;  // kd * 2 + kh; a chunk never straddles two runs
    const int within = col - ph * run;
    const long long dst =
        (((nn * 2 * D + 2 * dd + (ph >> 1)) * 2 * H + 2 * hh + (ph & 1)) * 2 * W + 2 * ww) * co +
        within;
    *reinterpret_cast<uint4*>(y + dst) = *reinterpret_cast<const uint4*>(&sC[r][cc]);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an integer handle).  Returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int upconv2x_launch(const void* x, const void* w, void* y, int N, int D, int H, int W,
                               int ci, int co, void* stream) {
  const long long M = static_cast<long long>(N) * D * H * W;
  const int col_tiles = (8 * co + BN - 1) / BN;
  const long long tiles = (M + BM - 1) / BM * col_tiles;
  if (tiles <= 0 || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  upconv2x_kernel<<<static_cast<unsigned>(tiles), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), D, H, W, ci, co, M, col_tiles);
  return static_cast<int>(cudaGetLastError());
}
