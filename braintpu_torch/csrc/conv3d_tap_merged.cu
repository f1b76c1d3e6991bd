// Stride-1 SAME 3x3x3 convolution on NDHWC bf16, fused bias + optional
// LeakyReLU, bf16 output with f32 accumulation -- hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel braintpu/ops/conv3d_pallas.py::conv3d_tap_merged
// (body `_kernel`, wrapper `_tap_merged_impl`), which computes the same
// function.  Python wrapper: braintpu_torch/ops/conv3d.py.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s HBM): at the main
// path's (1,56,56,32, 256->128) layer the conv does 2*100352*27*256*128 =
// 178 GFLOP against ~79 MB of input + weights + output (~23 us of HBM
// time), so it is compute-bound at ~0.18 ms.  Every layer this kernel takes
// has ci, co >= 64 and is compute-bound the same way, so the design spends
// its effort on feeding the tensor cores, not on bytes.
//
// Design.  The Pallas kernel keeps three rolling f32 accumulators over the
// depth axis because a TPU grid runs in order.  Hopper runs blocks in
// parallel, so nothing carries between blocks: this is an implicit GEMM
// with M = output voxels, N = co, K = 27 taps x ci.  Each block owns a tile
// of BM consecutive output voxels x BN output channels and walks all 27
// taps x ci inside the block.  Per K step it stages the shifted input rows
// (one 64-byte channel run per voxel, zero-filled by cp.async where the
// tap falls outside the volume or past ci) and the matching weight slice
// in shared memory, double-buffered, and runs bf16 mma.sync m16n8k16 with
// f32 accumulators in registers.  Bias and LeakyReLU are applied to the
// accumulators before the single bf16 store.  wgmma/TMA and a persistent
// schedule are later work.
//
// Contract (checked by the wrapper): x (N,D,H,W,ci) bf16 contiguous,
// w (3,3,3,ci,co) bf16 contiguous, b (co,) f32, y (N,D,H,W,co) bf16
// allocated by the caller; ci % 8 == 0, co % 8 == 0, 16-byte aligned
// pointers.  The kernel allocates nothing and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output voxels per block
constexpr int BN = 64;         // output channels per block
constexpr int BK = 32;         // input channels per K step (one tap)
constexpr int THREADS = 256;   // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int A_LD = BK + 8;   // 80-byte row pitch: conflict-free ldmatrix
constexpr int B_LD = BN + 8;   // 144-byte row pitch

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
conv3d_tap_merged_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y,
                         int D, int H, int W, int ci, int co, long long M,
                         float slope, int has_slope) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BK][B_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // warp tile rows [wm*32, wm*32+32)
  const int wn = warp >> 2;  // warp tile cols [wn*32, wn*32+32)
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // A tile: BM rows x 4 chunks of 8 channels; each thread copies 2 chunks,
  // rows (tid>>2) and (tid>>2)+64, chunk tid&3.  Decode the voxel once.
  const int a_kc = tid & 3;
  int a_row[2], a_n[2], a_d[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a_row[j] = (tid >> 2) + j * (THREADS / 4);
    long long m = m0 + a_row[j];
    a_ok[j] = m < M;
    long long t = a_ok[j] ? m : 0;
    a_w[j] = static_cast<int>(t % W);
    t /= W;
    a_h[j] = static_cast<int>(t % H);
    t /= H;
    a_d[j] = static_cast<int>(t % D);
    a_n[j] = static_cast<int>(t / D);
  }
  // B tile: BK rows x 8 chunks of 8 output channels, one chunk per thread.
  const int b_k = tid >> 3;
  const int b_c = (tid & 7) * 8;
  const bool b_col_ok = (n0 + b_c) < co;

  const int kchunks = (ci + BK - 1) / BK;
  const int iters = 27 * kchunks;

  auto load_stage = [&](int stage, int it) {
    const int tap = it / kchunks;
    const int c0 = (it - tap * kchunks) * BK;
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int dd = a_d[j] + kd - 1, hh = a_h[j] + kh - 1, ww = a_w[j] + kw - 1;
      const int c = c0 + a_kc * 8;
      const bool ok = a_ok[j] && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 &&
                      ww < W && c < ci;
      const __nv_bfloat16* src = x;
      if (ok) {
        src = x + ((((static_cast<long long>(a_n[j]) * D + dd) * H + hh) * W + ww) * ci + c);
      }
      cp_async16(smem_addr(&sA[stage][a_row[j]][a_kc * 8]), src, ok);
    }
    const int k = c0 + b_k;
    const bool okb = b_col_ok && k < ci;
    const __nv_bfloat16* srcb = w;
    if (okb) {
      srcb = w + ((static_cast<long long>(tap) * ci + k) * co + n0 + b_c);
    }
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

  // Epilogue: bias + LeakyReLU on the f32 accumulators, one bf16x2 store
  // per accumulator pair; ragged M and co edges are masked here.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (col >= co) continue;  // co % 8 == 0, so col + 1 < co as well
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 32 + mi * 16 + (lane >> 2) + half * 8;
        if (m >= M) continue;
        float v0 = acc[mi][ni][half * 2] + b0;
        float v1 = acc[mi][ni][half * 2 + 1] + b1;
        if (has_slope) {
          v0 = v0 >= 0.f ? v0 : v0 * slope;
          v1 = v1 >= 0.f ? v1 : v1 * slope;
        }
        *reinterpret_cast<__nv_bfloat162*>(y + m * co + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an integer handle).  Returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int conv3d_tap_merged_launch(const void* x, const void* w, const void* b, void* y,
                                        int N, int D, int H, int W, int ci, int co,
                                        float slope, int has_slope, void* stream) {
  const long long M = static_cast<long long>(N) * D * H * W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((co + BN - 1) / BN));
  conv3d_tap_merged_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), D, H, W, ci, co, M, slope,
      has_slope);
  return static_cast<int>(cudaGetLastError());
}
