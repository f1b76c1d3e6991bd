// Fused U-Net stage: per-channel input affine + LeakyReLU on one or two
// NDHWC bf16 inputs (the second concatenated on channels), stride-1 SAME
// 3x3x3 convolution + bias with f32 accumulation, optional per-sample
// channel sums of y and y^2, optional output LeakyReLU, bf16 output --
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel braintpu/ops/stage_pallas.py::conv_stage (body
// `_kernel`, oracle `_xla_reference`), which computes the same function.
// Python wrapper: braintpu_torch/ops/stage.py.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s HBM).  Every layer
// the GroupNorm model sends here does 2*27*ci*co flops per voxel against
// 2*(ci+co) bytes, at least 576 flops/byte (ci=64, co=32) where the card
// balances at ~295, so every call is compute-bound: the heaviest one of a
// 224x224x128 forward, the level-0 decoder conv (64+64 -> 64 at
// 224x224x128), does 2.84 TFLOP, 2.9 ms at peak, against 0.5 ms of HBM
// time.  The design therefore spends its effort on the tensor cores and
// keeps the extra work of the fusion (transform, statistics) off the
// critical path.
//
// Design.  The Pallas kernel walks the depth axis in order with rolling
// f32 accumulators and carries the running statistics in scratch from one
// grid step to the next; Hopper blocks run in parallel and in no order,
// so nothing carries between blocks.  This is an implicit GEMM with
// M = voxels of one sample, N = co, K = 27 taps x (ci1 + ci2), tiled like
// conv3d_tap_merged.cu: a block owns 128 consecutive voxels of one sample
// x 64 output channels and walks every tap and both inputs' channel
// chunks of 32 (the K range splits at 27*ci1 into two base pointers),
// double-buffered in shared memory, with bf16 mma.sync m16n8k16 into f32
// registers.
//   * Transform on load: cp.async cannot apply `a*x + c`, so the input
//     tile of the next K step travels through registers: each thread
//     fetches its two 16-byte chunks (and the chunk's affine) before the
//     tensor cores run the current step, then applies the f32 affine +
//     LeakyReLU, rounds to bf16 and stores to shared memory after, so the
//     loads and the transform hide behind the MMAs.  A chunk outside the
//     volume is a register of zeros that is stored untransformed, so SAME
//     padding stays zero in the transformed domain and never becomes
//     leaky(c).  Which taps of a row lie in the volume is a 27-bit mask
//     computed once per thread; the K step advances without divisions,
//     and one barrier per step hands the buffers over.  Weights go by
//     cp.async.
//   * Statistics: a block reduces sum(y) and sum(y^2) per channel over
//     its valid rows from the f32 accumulators + bias (before the output
//     LeakyReLU) with warp shuffles and shared-memory atomics, then adds
//     its partial into the (N, co) outputs with one global atomicAdd per
//     channel.  The wrapper zeroes those outputs on the stream.  No tile
//     straddles two samples (grid.y is the sample), and the atomics make
//     the summation order, so the last bits of the sums, vary between
//     runs.
// wgmma/TMA and a persistent schedule are later work.
//
// Contract (checked by the wrapper): x1 (N,D,H,W,ci1), x2 (N,D,H,W,ci2)
// or null, w (3,3,3,ci1+ci2,co) bf16, b (co,) f32, affines f32 with a
// per-sample row stride (0 when shared), y (N,D,H,W,co) bf16, s1/s2
// (N,co) f32 zeroed or null; all contiguous and 16-byte aligned; ci1, ci2,
// co multiples of 8.  The kernel allocates nothing and runs on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output voxels per block
constexpr int BN = 64;         // output channels per block
constexpr int BK = 32;         // input channels per K step (one tap, one input)
constexpr int THREADS = 256;   // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int A_LD = BK + 8;   // 80-byte row pitch: conflict-free ldmatrix
constexpr int B_LD = BN + 8;   // 144-byte row pitch

constexpr int F_AFF1 = 1, F_SLOPE1 = 2, F_AFF2 = 4, F_SLOPE2 = 8, F_OUT_SLOPE = 16,
              F_STATS = 32;

struct StageArgs {
  const __nv_bfloat16* x1;
  const __nv_bfloat16* x2;
  const __nv_bfloat16* w;
  const float* bias;
  const float* a1;
  const float* c1;
  const float* a2;
  const float* c2;
  __nv_bfloat16* y;
  float* s1;
  float* s2;
  int D, H, W, ci1, ci2, co;
  int a1_stride, a2_stride;  // per-sample row stride of the affines, 0 = shared
  float slope1, slope2, out_slope;
  int flags;
  int col_tiles;  // ceil(co / BN)
};

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

__global__ void __launch_bounds__(THREADS, 2) conv_stage_kernel(const StageArgs p) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BK][B_LD];
  __shared__ float sStat[2][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // warp tile rows [wm*32, wm*32+32)
  const int wn = warp >> 2;  // warp tile cols [wn*32, wn*32+32)
  // Column tiles vary fastest, so the blocks that share an input tile run
  // together and find it in L2.
  const int n0 = (blockIdx.x % p.col_tiles) * BN;
  const long long m0 = static_cast<long long>(blockIdx.x / p.col_tiles) * BM;
  const int n = blockIdx.y;  // sample
  const int D = p.D, H = p.H, W = p.W, co = p.co;
  const long long HW = static_cast<long long>(H) * W;
  const long long Mv = D * HW;  // voxels per sample
  const long long nbase = n * Mv;
  const int ci = p.ci1 + p.ci2;
  const int flags = p.flags;

  if (tid < 2 * BN) (&sStat[0][0])[tid] = 0.f;

  // A tile: BM rows x 4 chunks of 8 channels; each thread fetches 2 chunks,
  // rows (tid>>2) and (tid>>2)+64, chunk tid&3.  Per row: its voxel and a
  // 27-bit mask of the taps (bit kd*9 + kh*3 + kw) that fall in the volume.
  const int a_kc = tid & 3;
  int a_row[2];
  long long a_vox[2];
  uint32_t a_taps[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a_row[j] = (tid >> 2) + j * (THREADS / 4);
    const long long m = m0 + a_row[j];
    a_vox[j] = 0;
    a_taps[j] = 0;
    if (m < Mv) {
      const int w = static_cast<int>(m % W);
      const int h = static_cast<int>((m / W) % H);
      const int d = static_cast<int>(m / HW);
      a_vox[j] = m;
      for (int t = 0; t < 27; ++t) {
        const int dd = d + t / 9 - 1, hh = h + (t / 3) % 3 - 1, ww = w + t % 3 - 1;
        if (dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W) a_taps[j] |= 1u << t;
      }
    }
  }
  // B tile: BK rows x 8 chunks of 8 output channels, one chunk per thread.
  const int b_k = tid >> 3;
  const int b_c = (tid & 7) * 8;
  const bool b_col_ok = (n0 + b_c) < co;

  // K steps: for each tap, kc1 channel chunks of x1, then kc2 of x2.
  const int kc1 = (p.ci1 + BK - 1) / BK;
  const int kc2 = (p.ci2 + BK - 1) / BK;
  const int kchunks = kc1 + kc2;
  const int iters = 27 * kchunks;

  // The A chunks of the next K step travel through registers: fetched
  // before the tensor cores run the current step, transformed and stored
  // to shared memory after.
  uint4 ra[2];
  bool r_ok[2];
  float r_a[8], r_c[8];
  int r_src = 0;

  auto fetch_a = [&](int tap, int r) {
    r_src = r >= kc1;
    const int c = (r_src ? r - kc1 : r) * BK + a_kc * 8;
    const int cin = r_src ? p.ci2 : p.ci1;
    const __nv_bfloat16* xs = r_src ? p.x2 : p.x1;
    const long long delta = (tap / 9 - 1) * HW + ((tap / 3) % 3 - 1) * static_cast<long long>(W) +
                            (tap % 3 - 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      r_ok[j] = ((a_taps[j] >> tap) & 1u) && c < cin;
      ra[j] = make_uint4(0u, 0u, 0u, 0u);  // SAME padding: zeros, never transformed
      if (r_ok[j]) {
        ra[j] = __ldg(reinterpret_cast<const uint4*>(xs + (nbase + a_vox[j] + delta) * cin + c));
      }
    }
    if ((flags & (r_src ? F_AFF2 : F_AFF1)) && c < cin) {
      const long long off = static_cast<long long>(n) * (r_src ? p.a2_stride : p.a1_stride) + c;
      const float4* ap = reinterpret_cast<const float4*>((r_src ? p.a2 : p.a1) + off);
      const float4* cp = reinterpret_cast<const float4*>((r_src ? p.c2 : p.c1) + off);
      const float4 a0 = __ldg(ap), a1 = __ldg(ap + 1), q0 = __ldg(cp), q1 = __ldg(cp + 1);
      r_a[0] = a0.x; r_a[1] = a0.y; r_a[2] = a0.z; r_a[3] = a0.w;
      r_a[4] = a1.x; r_a[5] = a1.y; r_a[6] = a1.z; r_a[7] = a1.w;
      r_c[0] = q0.x; r_c[1] = q0.y; r_c[2] = q0.z; r_c[3] = q0.w;
      r_c[4] = q1.x; r_c[5] = q1.y; r_c[6] = q1.z; r_c[7] = q1.w;
    }
  };

  auto store_a = [&](int stage) {
    const bool aff = flags & (r_src ? F_AFF2 : F_AFF1);
    const bool lk = flags & (r_src ? F_SLOPE2 : F_SLOPE1);
    const float slope = r_src ? p.slope2 : p.slope1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4 v = ra[j];
      if (r_ok[j] && (aff || lk)) {
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 f = __bfloat1622float2(h2[e]);
          if (aff) {  // multiply, then add, each rounded: no FMA contraction
            f.x = __fadd_rn(__fmul_rn(f.x, r_a[2 * e]), r_c[2 * e]);
            f.y = __fadd_rn(__fmul_rn(f.y, r_a[2 * e + 1]), r_c[2 * e + 1]);
          }
          if (lk) {
            f.x = f.x >= 0.f ? f.x : f.x * slope;
            f.y = f.y >= 0.f ? f.y : f.y * slope;
          }
          h2[e] = __floats2bfloat162_rn(f.x, f.y);
        }
      }
      *reinterpret_cast<uint4*>(&sA[stage][a_row[j]][a_kc * 8]) = v;
    }
  };

  auto issue_b = [&](int stage, int tap, int r) {
    const int src = r >= kc1;
    const int k = (src ? r - kc1 : r) * BK + b_k;
    const bool okb = b_col_ok && k < (src ? p.ci2 : p.ci1);
    const __nv_bfloat16* srcb = p.w;
    if (okb) {
      const long long row = static_cast<long long>(tap) * ci + (src ? p.ci1 : 0) + k;
      srcb = p.w + (row * co + n0 + b_c);
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

  fetch_a(0, 0);
  issue_b(0, 0, 0);
  cp_async_commit();
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  int tap = 0, r = 0;  // the K step held in registers
  for (int it = 0; it < iters; ++it) {
    const int st = it & 1;
    const bool has_next = it + 1 < iters;
    if (has_next) {
      if (++r == kchunks) {
        r = 0;
        ++tap;
      }
      fetch_a(tap, r);
      issue_b(st ^ 1, tap, r);
      cp_async_commit();
    }
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
    // The other buffers were last read before the previous barrier, so
    // they are free; one barrier per K step hands them to the next.
    if (has_next) store_a(st ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // Epilogue.  Accumulator (mi, ni, half*2 + e) holds row
  // wm*32 + mi*16 + (lane>>2) + half*8, column wn*32 + ni*8 + (lane&3)*2 + e.
  const bool stats = flags & F_STATS;
  const bool out_lk = flags & F_OUT_SLOPE;
  __nv_bfloat16* yn = p.y + static_cast<long long>(n) * Mv * co;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int lcol = wn * 32 + ni * 8 + (lane & 3) * 2;
    const int col = n0 + lcol;
    const bool col_ok = col < co;  // co % 8 == 0, so col + 1 < co as well
    const float b0 = col_ok ? p.bias[col] : 0.f;
    const float b1 = col_ok ? p.bias[col + 1] : 0.f;
    float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 32 + mi * 16 + (lane >> 2) + half * 8;
        if (m >= Mv || !col_ok) continue;
        float v0 = acc[mi][ni][half * 2] + b0;
        float v1 = acc[mi][ni][half * 2 + 1] + b1;
        t1[0] += v0;
        t1[1] += v1;
        t2[0] += v0 * v0;
        t2[1] += v1 * v1;
        if (out_lk) {
          v0 = v0 >= 0.f ? v0 : v0 * p.out_slope;
          v1 = v1 >= 0.f ? v1 : v1 * p.out_slope;
        }
        *reinterpret_cast<__nv_bfloat162*>(yn + m * co + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
    if (stats) {
      // sum over the 8 lanes that share (lane & 3): the warp's 32 rows
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          t1[e] += __shfl_xor_sync(0xffffffffu, t1[e], off);
          t2[e] += __shfl_xor_sync(0xffffffffu, t2[e], off);
        }
      }
      if (lane < 4 && col_ok) {
        atomicAdd(&sStat[0][lcol], t1[0]);
        atomicAdd(&sStat[0][lcol + 1], t1[1]);
        atomicAdd(&sStat[1][lcol], t2[0]);
        atomicAdd(&sStat[1][lcol + 1], t2[1]);
      }
    }
  }
  if (stats) {
    __syncthreads();
    if (tid < BN && n0 + tid < co) {
      atomicAdd(p.s1 + static_cast<long long>(n) * co + n0 + tid, sStat[0][tid]);
      atomicAdd(p.s2 + static_cast<long long>(n) * co + n0 + tid, sStat[1][tid]);
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an integer handle).  Returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int conv_stage_launch(const void* x1, const void* x2, const void* w, const void* b,
                                 const void* a1, const void* c1, const void* a2, const void* c2,
                                 void* y, void* s1, void* s2, int N, int D, int H, int W,
                                 int ci1, int ci2, int co, int a1_stride, int a2_stride,
                                 float slope1, float slope2, float out_slope, int flags,
                                 void* stream) {
  StageArgs p;
  p.x1 = static_cast<const __nv_bfloat16*>(x1);
  p.x2 = static_cast<const __nv_bfloat16*>(x2);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(b);
  p.a1 = static_cast<const float*>(a1);
  p.c1 = static_cast<const float*>(c1);
  p.a2 = static_cast<const float*>(a2);
  p.c2 = static_cast<const float*>(c2);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.s1 = static_cast<float*>(s1);
  p.s2 = static_cast<float*>(s2);
  p.D = D;
  p.H = H;
  p.W = W;
  p.ci1 = ci1;
  p.ci2 = ci2;
  p.co = co;
  p.a1_stride = a1_stride;
  p.a2_stride = a2_stride;
  p.slope1 = slope1;
  p.slope2 = slope2;
  p.out_slope = out_slope;
  p.flags = flags;
  p.col_tiles = (co + BN - 1) / BN;
  const long long Mv = static_cast<long long>(D) * H * W;
  const long long tiles = (Mv + BM - 1) / BM * p.col_tiles;
  if (N <= 0 || tiles <= 0 || tiles > 0x7fffffffLL || N > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(N));
  conv_stage_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
