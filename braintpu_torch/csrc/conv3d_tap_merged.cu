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
// with M = output voxels, N = co, K = 27 taps x ci, on the shared main
// loop of conv3d_wgmma.cuh: a block owns a box of 256, 128 or 64 output
// voxels x BN output channels (BN = 32..256 after co, two column tiles of
// 160 at co = 320), one producer warp keeps a ring of >= 3 TMA stages in
// flight (the input box shifted by the tap, halo and ragged channels
// zero-filled by the tensor map; the weights' 64 x BN slice as stored),
// and one, two or four consumer warpgroups run wgmma m64nBNk16 with both
// operands in shared memory into f32 registers.  Bias and LeakyReLU are
// applied to the accumulators before the single bf16 store, which masks
// the rows of a ragged box.  The plan (box, BM, BN, stages) comes from
// braintpu_torch/ops/conv_plan.py.  Split-K for the deep layers and a
// persistent tile schedule are later work.
//
// Contract (checked by the wrapper): x (N,D,H,W,ci) bf16 contiguous,
// w (3,3,3,ci,co) bf16 contiguous, b (co,) f32, y (N,D,H,W,co) bf16
// allocated by the caller; ci % 8 == 0, co % 8 == 0, 16-byte aligned
// pointers.  The kernel allocates nothing and runs on the caller's stream.

#include "conv3d_wgmma.cuh"

namespace {

using conv3d_wgmma::Args;

template <int BN, int NC>
__global__ void __launch_bounds__(conv3d_wgmma::block_threads<NC>(), 1)
    conv3d_tap_merged_kernel(const __grid_constant__ CUtensorMap mx,
                             const __grid_constant__ CUtensorMap mw, const Args p) {
  conv3d_wgmma::body<BN, NC, false>(&mx, &mx, &mw, &mw, p);
}

struct Launch {
  const CUtensorMap& mx;
  const CUtensorMap& mw;
  const Args& p;
  dim3 grid;
  long long smem;
  cudaStream_t stream;
  template <int BN, int NC>
  int run() const {
    return conv3d_wgmma::launch(conv3d_tap_merged_kernel<BN, NC>, grid,
                                conv3d_wgmma::block_threads<NC>(), smem, stream, mx,
                                mw, p);
  }
};

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an integer handle) with the
// host's plan (box bd x bh x bw = bm rows, bn columns, stages, shared-memory
// bytes).  Returns 0 when the launch was accepted, cudaErrorInvalidValue
// for a plan or shape the kernel cannot take, else the error of
// cudaFuncSetAttribute or of the launch.
extern "C" int conv3d_tap_merged_launch(const void* x, const void* w, const void* b, void* y,
                                        int N, int D, int H, int W, int ci, int co,
                                        float slope, int has_slope, int bd, int bh, int bw,
                                        int bm, int bn, int stages, long long smem,
                                        void* stream) {
  Args p = {};
  p.N = N, p.D = D, p.H = H, p.W = W, p.ci1 = ci, p.ci2 = 0, p.co = co;
  p.d_lo = 0, p.d_hi = D;
  p.bias = static_cast<const float*>(b);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.out_slope = slope;
  p.flags = has_slope ? conv3d_wgmma::F_OUT_SLOPE : 0;
  long long grid_x = 0;
  if (!conv3d_wgmma::plan_ok(p, bd, bh, bw, bm, bn, stages, smem, false, &grid_x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mx, mw;
  if (!conv3d_wgmma::encode_input(&mx, x, N, D, H, W, ci, bd, bh, bw) ||
      !conv3d_wgmma::encode_weights(&mw, w, ci, 0, ci, co)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch l{mx, mw, p, dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(N)), smem,
                 static_cast<cudaStream_t>(stream)};
  return conv3d_wgmma::dispatch(bn, bm, l);
}
