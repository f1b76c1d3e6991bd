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
// M = voxels of one sample, N = co, K = 27 taps x (ci1 + ci2), on the
// main loop shared with conv3d_tap_merged.cu (conv3d_wgmma.cuh): a block
// owns a box of 256, 128 or 64 voxels of one sample x BN output channels
// (BN = 32..256 after co, two column tiles of 160 at co = 320); one
// producer warp keeps a ring of >= 3 TMA stages in flight, each one tap x
// 64 channels of one input (the K range splits at 27*ci1 into the two
// inputs' tensor maps), with the halo and channels past ci zero-filled by
// the map; one, two or four consumer warpgroups run wgmma m64nBNk16
// with B (the weights as stored) from shared memory.
//   * Transform on the A operand (wgmma RS): TMA cannot apply `a*x + c`,
//     so each consumer warpgroup ldmatrix-es its 64 x 64 slice of the
//     landed, swizzled tile into registers, applies the per-sample channel
//     affine (a table in shared memory, zeros past ci) and LeakyReLU in
//     f32, rounds to bf16 and issues wgmma with A from registers.  Rows
//     whose tapped voxel lies outside the volume (a 27-bit mask per row,
//     computed once) are re-zeroed after the transform, so SAME padding
//     stays zero in the transformed domain and never becomes leaky(c).
//     Each step's products drain before the next step rewrites A (ptxas
//     serialises the loop otherwise); the two consumer warpgroups run out
//     of step, so one's products overlap the other's transform.
//   * Statistics: a block reduces sum(y) and sum(y^2) per channel over
//     its valid rows from the f32 accumulators + bias (before the output
//     LeakyReLU) with warp shuffles and shared-memory atomics, then adds
//     its partial into the (N, co) outputs with one global atomicAdd per
//     channel.  The wrapper zeroes those outputs on the stream.  No tile
//     straddles two samples (grid.y is the sample), and the atomics make
//     the summation order, so the last bits of the sums, vary between
//     runs.
//   * The kernel computes output planes d_lo <= d < d_hi only (the wrapper
//     passes 0, D unless asked otherwise): y holds those d_hi - d_lo
//     planes, the sums cover them, and their 3x3x3 window reads input
//     planes d_lo - 1 .. d_hi (zeros beyond the volume).  An X-sharded
//     forward feeds the kernel its neighbours' boundary planes and asks for
//     its own planes: the tiles cover them alone.
// The plan (box, BM, BN, stages) comes from braintpu_torch/ops/
// conv_plan.py.  Split-K for the deep layers and a persistent tile
// schedule are later work.
//
// Contract (checked by the wrapper): x1 (N,D,H,W,ci1), x2 (N,D,H,W,ci2)
// or null, w (3,3,3,ci1+ci2,co) bf16, b (co,) f32, affines f32 with a
// per-sample row stride (0 when shared), y (N,D,H,W,co) bf16, s1/s2
// (N,co) f32 zeroed or null; all contiguous and 16-byte aligned; ci1, ci2,
// co multiples of 8.  The kernel allocates nothing and runs on the
// caller's stream.

#include "conv3d_wgmma.cuh"

namespace {

using conv3d_wgmma::Args;

template <int BN, int NC>
__global__ void __launch_bounds__(conv3d_wgmma::block_threads<NC>(), 1)
    conv_stage_kernel(const __grid_constant__ CUtensorMap mx1,
                      const __grid_constant__ CUtensorMap mx2,
                      const __grid_constant__ CUtensorMap mw1,
                      const __grid_constant__ CUtensorMap mw2, const Args p) {
  conv3d_wgmma::body<BN, NC, true>(&mx1, &mx2, &mw1, &mw2, p);
}

struct Launch {
  const CUtensorMap& mx1;
  const CUtensorMap& mx2;
  const CUtensorMap& mw1;
  const CUtensorMap& mw2;
  const Args& p;
  dim3 grid;
  long long smem;
  cudaStream_t stream;
  template <int BN, int NC>
  int run() const {
    return conv3d_wgmma::launch(conv_stage_kernel<BN, NC>, grid,
                                conv3d_wgmma::block_threads<NC>(), smem, stream, mx1, mx2,
                                mw1, mw2, p);
  }
};

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an integer handle) with the
// output planes [d_lo, d_hi) and the host's plan
// (box bd x bh x bw = bm rows, bn columns, stages, shared-memory bytes).
// Returns 0 when the launch was accepted, cudaErrorInvalidValue for a plan,
// shape or window the kernel cannot take, else the error of
// cudaFuncSetAttribute or of the launch.
extern "C" int conv_stage_launch(const void* x1, const void* x2, const void* w, const void* b,
                                 const void* a1, const void* c1, const void* a2, const void* c2,
                                 void* y, void* s1, void* s2, int N, int D, int H, int W,
                                 int ci1, int ci2, int co, int a1_stride, int a2_stride,
                                 int d_lo, int d_hi, float slope1, float slope2,
                                 float out_slope, int flags,
                                 int bd, int bh, int bw, int bm, int bn, int stages,
                                 long long smem, void* stream) {
  Args p = {};
  p.N = N, p.D = D, p.H = H, p.W = W, p.ci1 = ci1, p.ci2 = ci2, p.co = co;
  p.bias = static_cast<const float*>(b);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.a1 = static_cast<const float*>(a1);
  p.c1 = static_cast<const float*>(c1);
  p.a2 = static_cast<const float*>(a2);
  p.c2 = static_cast<const float*>(c2);
  p.a1_stride = a1_stride;
  p.a2_stride = a2_stride;
  p.slope1 = slope1;
  p.slope2 = slope2;
  p.out_slope = out_slope;
  p.s1 = static_cast<float*>(s1);
  p.s2 = static_cast<float*>(s2);
  p.flags = flags;
  p.d_lo = d_lo, p.d_hi = d_hi;  // plan_ok checks 0 <= d_lo < d_hi <= D
  long long grid_x = 0;
  if (!conv3d_wgmma::plan_ok(p, bd, bh, bw, bm, bn, stages, smem, true, &grid_x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((ci2 > 0) != (x2 != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int ci = ci1 + ci2;
  CUtensorMap mx1, mx2, mw1, mw2;
  if (!conv3d_wgmma::encode_input(&mx1, x1, N, D, H, W, ci1, bd, bh, bw) ||
      !conv3d_wgmma::encode_weights(&mw1, w, ci, 0, ci1, co)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mx2 = mx1;
  mw2 = mw1;
  if (ci2 > 0 && (!conv3d_wgmma::encode_input(&mx2, x2, N, D, H, W, ci2, bd, bh, bw) ||
                  !conv3d_wgmma::encode_weights(&mw2, w, ci, ci1, ci2, co))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch l{mx1, mx2, mw1, mw2, p,
                 dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(N)), smem,
                 static_cast<cudaStream_t>(stream)};
  return conv3d_wgmma::dispatch(bn, bm, l);
}
