// Shared Hopper main loop of the two 3x3x3 convolution kernels
// (conv3d_tap_merged.cu, conv_stage.cu): a warp-specialised implicit GEMM
// on wgmma, fed by TMA through an mbarrier ring.  Included by both
// sources; it defines no launcher of its own.  upconv2x.cu and
// int8_matmul.cu include it for its PTX wrappers (mbarriers, TMA loads and
// stores, descriptors, wgmma) and keep their own main loops.
//
// GEMM view.  M = output voxels, N = co, K = 27 taps x channels.  A block
// owns BM output voxels (a box bd x bh x bw inside one sample, not BM
// consecutive linear voxels) x BN output channels and walks every K step:
// one tap x 64 channels of one input.  For the fused stage the K range
// runs over x1's channel chunks and then x2's for each tap, as the weights
// (3,3,3,ci1+ci2,co) order them.
//
// Operands.
//   * A: one 5-D TMA load per K step (dims c, w, h, d, n) of the input box
//     shifted by the tap, (d0+kd-1, h0+kh-1, w0+kw-1), at channel offset c0.
//     Signed coordinates let the halo reach -1; the tensor map's zero fill
//     (FLOAT_OOB_FILL_NONE) covers everything outside the volume and past
//     ci, so SAME padding and ragged ci cost nothing.  BM rows of 128
//     bytes, 128-byte swizzle, read K-major by wgmma.
//   * B: the weights as stored, (tap, c, co) with co contiguous, through a
//     3-D tensor map (co, c, tap); each K step lands BN/32 boxes of
//     32 co x 64 c (64-byte rows, 64-byte swizzle) that wgmma reads
//     N-major through its transpose bit.  No repacked copy of the weights
//     exists anywhere.
// Block.  Warpgroup 0 is the producer: one thread issues the TMA loads,
// and with two consumers the warpgroup gives its registers away with
// setmaxnreg.  NC = 1, 2 or 4 consumer warpgroups (4 only for BN <= 64,
// where a taller tile reads each B tile for more rows) each own 64 rows x
// BN columns in f32 registers.  A ring of S >= 3 stages with full and empty
// mbarriers hands the tiles over; there is no block-wide barrier in the
// loop.
//   * Plain convolution: wgmma with both operands in shared memory (SS);
//     each consumer keeps one step of products in flight while it waits
//     for the next tile.
//   * Stage kernel (STAGE): each consumer ldmatrix-es its 64 x 64 A slice
//     from the swizzled tile, applies the per-channel affine + LeakyReLU in
//     f32, sets the halo rows and the channels past ci back to zero (TMA's
//     zeros would otherwise become leaky(c)), rounds to bf16 and issues
//     wgmma with A from registers (RS).  The A registers and accumulators
//     are pinned with empty asm operands before the products, and each
//     step's products drain before the next step rewrites A: otherwise
//     ptxas serialises every wgmma of the loop (its C7515 notice).  The two
//     consumer warpgroups run out of step, so one's products overlap the
//     other's transform.
//
// The plan (box, BM, BN, stages, shared-memory bytes) is chosen on the
// host, by braintpu_torch/ops/conv_plan.py, and checked here by
// plan_ok(); the shared-memory layout below must match that
// module's conv_plan_smem_bytes().

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3d_wgmma {

constexpr int KC = 64;             // channels per K step: 128-byte A rows
constexpr int ROW_BYTES = KC * 2;  // one A row and one B column strip
constexpr int B_BOX = 32;          // co per B box: 64-byte rows
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;  // per block on an H100 (227 KiB)
constexpr int ALIGN_SLACK = 1024;   // dynamic shared memory aligned up to 1024

constexpr int F_AFF1 = 1, F_SLOPE1 = 2, F_AFF2 = 4, F_SLOPE2 = 8, F_OUT_SLOPE = 16,
              F_STATS = 32;

struct Args {
  int N, D, H, W;
  int ci1, ci2, co;
  int kc1, kc2;  // 64-channel chunks of each input
  int bd, bh, bw, stages;  // the plan's box and ring depth (BM, BN are template arguments)
  int tiles_h, tiles_w, col_tiles;
  const float* bias;
  __nv_bfloat16* y;
  // stage only
  const float* a1;
  const float* c1;
  const float* a2;
  const float* c2;
  int a1_stride, a2_stride;
  float slope1, slope2, out_slope;
  float* s1;
  float* s2;
  int d_lo, d_hi;  // output planes computed, d_lo <= d < d_hi: y holds d_hi - d_lo of them
  int flags;
};

// Shared-memory bytes of a plan; ops/conv_plan.py computes the same.
__host__ __device__ inline long long smem_bytes(int bm, int bn, int stages, int kc1, int kc2,
                                                bool stage) {
  long long b = ALIGN_SLACK + static_cast<long long>(stages) * (bm + bn) * ROW_BYTES +
                2LL * stages * 8;
  if (stage) b += (2LL * KC * (kc1 + kc2) + 2LL * bn) * 4;
  return b;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of `bar` with the given parity.  A wait that never
// ends (a fault in the ring's bookkeeping) traps after ~2^26 polls, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The loads and stores below serve the up-conv (upconv2x.cu) and the int8
// product (int8_matmul.cu), which include this header for its wrappers only.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared -> global tensor store, one bulk group per commit; elements
// outside the map's bounds are not written.  `policy` is an L2 eviction
// policy (l2_evict_first(): data written once and not read back soon).
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4, %5, %6}], [%1], %7;\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4), "l"(policy)
      : "memory");
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// All but the newest N bulk groups have finished reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory become visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier over `threads` threads of the block (id 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Shared-memory matrix descriptors.  A: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (SBO); a k16 step moves the start 32 bytes.
// B: N-major (read with the transpose bit), 64-byte swizzle: 32-co atoms
// 4096 bytes apart (LBO, one TMA box each), 8-k groups 512 bytes apart
// (SBO); a k16 step moves the start 1024 bytes.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(4096 >> 4) << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (2ull << 62);
}

// wgmma m64nNk16 bf16 -> f32, accumulating (scale-d = 1; SS takes
// scale_d = 0 to overwrite d instead, which spares zeroing the accumulators
// with ordinary instructions).  B comes from shared memory, N-major through
// the transpose bit; A from shared memory, K-major (SS), or from registers
// (RS).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d = 1);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<160>(float (&d)[80], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Pins a register's value at this point for the compiler (CUTLASS's
// warpgroup_fence_operand): an instruction that defines it cannot sink
// past a wgmma that reads it.
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float leaky(float v, float s) { return v >= 0.f ? v : v * s; }

// Threads of a block: the producer warpgroup and NC consumer warpgroups.
template <int NC>
__host__ __device__ constexpr int block_threads() {
  return 128 * (1 + NC);
}

// The A fragment of one K step for one consumer warpgroup (wgmma RS):
// ldmatrix from the swizzled tile, then the input's affine + LeakyReLU in
// f32 (multiply, then add, each rounded: no FMA contraction, as the plain
// version computes it), the halo rows set back to 0 (TMA's zeros would
// otherwise become leaky(c)), bf16.  af[kk][q] holds rows R (q even) or
// R + 8 (q odd), channels kk*16 + (q/2)*8 + 2t and + 1.  FAST: affine and
// a slope in [0, 1], where leaky(v) = max(v, slope * v).
template <bool FAST>
__device__ __forceinline__ void transform_a(uint32_t (&af)[KC / 16][4], const float* ta,
                                            const float* tc, bool aff, bool lk, float slope,
                                            bool ok0, bool ok1, int t) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ch = kk * 16 + hf * 8 + 2 * t;
      float2 a = make_float2(1.f, 1.f), c = make_float2(0.f, 0.f);
      if (FAST || aff) {
        a = *reinterpret_cast<const float2*>(ta + ch);
        c = *reinterpret_cast<const float2*>(tc + ch);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t& v = af[kk][2 * hf + i];
        float f0 = __uint_as_float(v << 16), f1 = __uint_as_float(v & 0xffff0000u);
        if (FAST || aff) {
          f0 = __fadd_rn(__fmul_rn(f0, a.x), c.x);
          f1 = __fadd_rn(__fmul_rn(f1, a.y), c.y);
        }
        if (FAST) {
          f0 = fmaxf(f0, f0 * slope);
          f1 = fmaxf(f1, f1 * slope);
        } else if (lk) {
          f0 = leaky(f0, slope);
          f1 = leaky(f1, slope);
        }
        __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
        v = (i ? ok1 : ok0) ? *reinterpret_cast<uint32_t*>(&h) : 0u;
      }
    }
  }
}

// The kernel body.  BN output channels per block, NC consumer warpgroups
// (BM = 64 * NC rows, NC = 1, 2 or 4), STAGE: the fused stage (A through registers with
// the input transform, statistics) rather than the plain convolution (A
// and B from shared memory).  mx2/mw2 are the second input's maps (unused
// when ci2 == 0).
template <int BN, int NC, bool STAGE>
__device__ __forceinline__ void body(const CUtensorMap* mx1, const CUtensorMap* mx2,
                                     const CUtensorMap* mw1, const CUtensorMap* mw2,
                                     const Args& p) {
  constexpr int A_BYTES = 64 * NC * ROW_BYTES;
  constexpr int B_BYTES = BN * ROW_BYTES;
  constexpr int NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = p.stages;
  uint8_t* sA = smem;
  uint8_t* sB = smem + S * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + S * B_BYTES);  // TMA landed
  uint64_t* empty = full + S;                                       // products done
  float* aff = reinterpret_cast<float*>(empty + S);  // STAGE: a1 | c1 | a2 | c2
  float* stat = aff + 2 * KC * (p.kc1 + p.kc2);        // STAGE: sum y | sum y^2, BN each

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  // Column tiles vary fastest, so the blocks that share an input box run
  // together and find it in L2.
  const int col = blockIdx.x % p.col_tiles;
  const int sp = blockIdx.x / p.col_tiles;
  const int d0 = p.d_lo + sp / (p.tiles_w * p.tiles_h) * p.bd;
  const int h0 = (sp / p.tiles_w) % p.tiles_h * p.bh;
  const int w0 = sp % p.tiles_w * p.bw;
  const int n = blockIdx.y;
  const int n0 = col * BN;
  const int kcs = p.kc1 + p.kc2;
  const int steps = 27 * kcs;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * NC);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (STAGE) {
    // Affine table: per input, a then c over its channel chunks; zeros
    // past ci, so channels that TMA filled with zeros stay zero.
    const int n1 = KC * p.kc1, n2 = KC * p.kc2;
    for (int i = tid; i < n1; i += blockDim.x) {
      const bool ok = (p.flags & F_AFF1) && i < p.ci1;
      aff[i] = ok ? p.a1[static_cast<long long>(n) * p.a1_stride + i] : 0.f;
      aff[n1 + i] = ok ? p.c1[static_cast<long long>(n) * p.a1_stride + i] : 0.f;
    }
    for (int i = tid; i < n2; i += blockDim.x) {
      const bool ok = (p.flags & F_AFF2) && i < p.ci2;
      aff[2 * n1 + i] = ok ? p.a2[static_cast<long long>(n) * p.a2_stride + i] : 0.f;
      aff[2 * n1 + n2 + i] = ok ? p.c2[static_cast<long long>(n) * p.a2_stride + i] : 0.f;
    }
    for (int i = tid; i < 2 * BN; i += blockDim.x) stat[i] = 0.f;
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -------------------------
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0, tap = 0, r = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t fb = smem_u32(&full[stage]);
        mbar_expect_tx(fb, A_BYTES + B_BYTES);
        const bool second = r >= p.kc1;
        const int c0 = (second ? r - p.kc1 : r) * KC;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        tma_load_5d(smem_u32(sA + stage * A_BYTES), second ? mx2 : mx1, fb, c0, w0 + kw - 1,
                    h0 + kh - 1, d0 + kd - 1, n);
#pragma unroll
        for (int i = 0; i < BN / B_BOX; ++i) {
          tma_load_3d(smem_u32(sB + stage * B_BYTES + i * B_BOX * ROW_BYTES),
                      second ? mw2 : mw1, fb, n0 + i * B_BOX, c0, tap);
        }
        if (++r == kcs) {
          r = 0;
          ++tap;
        }
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows [64c, 64c + 64) ----------------------
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int warp = (tid & 127) >> 5;
  const int g = lane >> 2, t = lane & 3;
  // This thread's accumulator rows, and its A rows in RS: R and R + 8.
  int vd[2], vh[2], vw[2];
  bool inside[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int R = c * 64 + warp * 16 + g + 8 * j;
    vw[j] = w0 + R % p.bw;
    vh[j] = h0 + (R / p.bw) % p.bh;
    vd[j] = d0 + R / (p.bw * p.bh);
    inside[j] = vd[j] < p.d_hi && vh[j] < p.H && vw[j] < p.W;
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  if constexpr (STAGE) {
    // Which taps of each of the thread's two rows fall inside the volume:
    // bit kd*9 + kh*3 + kw.
    uint32_t taps[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      for (int q = 0; q < 27; ++q) {
        const int dd = vd[j] + q / 9 - 1, hh = vh[j] + (q / 3) % 3 - 1, ww = vw[j] + q % 3 - 1;
        if (dd >= 0 && dd < p.D && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W) taps[j] |= 1u << q;
      }
    }
    const int arow = c * 64 + warp * 16 + (lane & 15);  // the row this lane's ldmatrix reads
    int tap = 0, r = 0;
    for (int s = 0; s < steps; ++s) {
      const bool second = r >= p.kc1;
      const bool do_aff = p.flags & (second ? F_AFF2 : F_AFF1);
      const bool do_lk = p.flags & (second ? F_SLOPE2 : F_SLOPE1);
      const float slope = second ? p.slope2 : p.slope1;
      const int c0 = (second ? r - p.kc1 : r) * KC;
      const float* ta = aff + (second ? 2 * KC * p.kc1 : 0) + c0;
      const float* tc = ta + KC * (second ? p.kc2 : p.kc1);
      const bool ok0 = (taps[0] >> tap) & 1u, ok1 = (taps[1] >> tap) & 1u;

      mbar_wait(smem_u32(&full[stage]), phase);
      const uint8_t* tile = sA + stage * A_BYTES;
      uint32_t af[KC / 16][4];
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const int chunk = kk * 2 + (lane >> 4);
        ldmatrix_x4(af[kk], smem_u32(tile + arow * ROW_BYTES + ((chunk ^ (arow & 7)) << 4)));
      }
      if (do_aff && do_lk && slope >= 0.f && slope <= 1.f) {
        transform_a<true>(af, ta, tc, true, true, slope, ok0, ok1, t);
      } else if (do_aff || do_lk) {
        transform_a<false>(af, ta, tc, do_aff, do_lk, slope, ok0, ok1, t);
      }  // else TMA's zeros are the padding as they are
      // Pin A and the accumulators here: an instruction that defines them
      // must not sink between the wgmmas, or ptxas serialises every one.
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_operand(af[kk][q]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_operand(acc[i]);
      const uint32_t b_base = smem_u32(sB + stage * B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        wgmma_rs<BN>(acc, af[kk], desc_b(b_base + kk * 16 * 64));
      }
      wgmma_commit();
      // The next step rewrites the A registers: drain this step first (ptxas
      // serialises the whole loop when A is rewritten with products in
      // flight).  The other consumer warpgroup's products fill the gap.
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_operand(acc[i]);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
      if (++r == kcs) {
        r = 0;
        ++tap;
      }
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    int prev = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t a_base = smem_u32(sA + stage * A_BYTES + c * 64 * ROW_BYTES);
      const uint32_t b_base = smem_u32(sB + stage * B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        wgmma_ss<BN>(acc, desc_a(a_base + kk * 32), desc_b(b_base + kk * 16 * 64));
      }
      wgmma_commit();
      // keep this step's products in flight; the previous step's are done
      if (s > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));
      }
      prev = stage;
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
  }

  // ---- epilogue: acc[4j + 2i + e] is row R + 8i, column 8j + 2t + e ---------
  const bool stats = STAGE && (p.flags & F_STATS);
  const bool out_lk = p.flags & F_OUT_SLOPE;
  long long vox[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    vox[i] = ((static_cast<long long>(n) * (p.d_hi - p.d_lo) + vd[i] - p.d_lo) * p.H + vh[i])
             * p.W + vw[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int lcol = 8 * j + 2 * t;
    const int gcol = n0 + lcol;
    const bool col_ok = gcol < p.co;  // co % 8 == 0, so gcol + 1 < co as well
    const float b0 = col_ok ? p.bias[gcol] : 0.f;
    const float b1 = col_ok ? p.bias[gcol + 1] : 0.f;
    float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[4 * j + 2 * i] + b0;
      float v1 = acc[4 * j + 2 * i + 1] + b1;
      if (!(inside[i] && col_ok)) continue;
      t1[0] += v0;
      t1[1] += v1;
      t2[0] += v0 * v0;
      t2[1] += v1 * v1;
      if (out_lk) {
        v0 = leaky(v0, p.out_slope);
        v1 = leaky(v1, p.out_slope);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.y + vox[i] * p.co + gcol) =
          __floats2bfloat162_rn(v0, v1);
    }
    if (stats) {
      // sum over the 8 lanes that share t: the warp's 16 rows
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          t1[e] += __shfl_xor_sync(0xffffffffu, t1[e], off);
          t2[e] += __shfl_xor_sync(0xffffffffu, t2[e], off);
        }
      }
      if (lane < 4 && col_ok) {
        atomicAdd(&stat[lcol], t1[0]);
        atomicAdd(&stat[lcol + 1], t1[1]);
        atomicAdd(&stat[BN + lcol], t2[0]);
        atomicAdd(&stat[BN + lcol + 1], t2[1]);
      }
    }
  }
  if (stats) {
    asm volatile("bar.sync 1, %0;\n" ::"r"(128 * NC) : "memory");  // consumers only
    for (int i = tid - 128; i < BN && n0 + i < p.co; i += 128 * NC) {
      atomicAdd(p.s1 + static_cast<long long>(n) * p.co + n0 + i, stat[i]);
      atomicAdd(p.s2 + static_cast<long long>(n) * p.co + n0 + i, stat[BN + i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, plan check, dispatch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links nothing but the runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 5-D map of an (N, D, H, W, ci) bf16 input: box 64 c x bw x bh x bd x 1,
// 128-byte swizzle, zeros outside.
inline bool encode_input(CUtensorMap* m, const void* x, int N, int D, int H, int W, int ci,
                         int bd, int bh, int bw) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = 2;
  cuuint64_t dims[5] = {(cuuint64_t)ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)N};
  cuuint64_t strides[4] = {ci * e, (cuuint64_t)W * ci * e, (cuuint64_t)H * W * ci * e,
                           (cuuint64_t)D * H * W * ci * e};
  cuuint32_t box[5] = {(cuuint32_t)KC, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bd, 1};
  cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 3-D map (co, c, tap) of the rows [c_off, c_off + cik) of the weights
// (3,3,3,ci,co): box 32 co x 64 c x 1 tap, 64-byte swizzle, zeros past cik
// and co.
inline bool encode_weights(CUtensorMap* m, const void* w, int ci, int c_off, int cik, int co) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = 2;
  cuuint64_t dims[3] = {(cuuint64_t)co, (cuuint64_t)cik, 27};
  cuuint64_t strides[2] = {co * e, (cuuint64_t)ci * co * e};
  cuuint32_t box[3] = {(cuuint32_t)B_BOX, (cuuint32_t)KC, 1};
  cuuint32_t one[3] = {1, 1, 1};
  void* base = const_cast<char*>(static_cast<const char*>(w)) + (size_t)c_off * co * e;
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Fill the plan fields of `p` from the host's plan and check it; false on
// a plan this code cannot take.
inline bool plan_ok(Args& p, int bd, int bh, int bw, int bm, int bn, int stages,
                    long long smem, bool stage, long long* grid_x) {
  p.bd = bd, p.bh = bh, p.bw = bw, p.stages = stages;
  if (p.N <= 0 || p.N > 65535 || p.D <= 0 || p.H <= 0 || p.W <= 0 || p.co <= 0) return false;
  if (p.d_lo < 0 || p.d_hi > p.D || p.d_lo >= p.d_hi) return false;
  if (p.ci1 <= 0 || p.ci1 % 8 || p.ci2 < 0 || p.ci2 % 8 || p.co % 8) return false;
  if (bm != 64 && bm != 128 && !(bm == 256 && bn <= 64)) return false;
  if (bd < 1 || bh < 1 || bw < 1 || bd > 256 || bh > 256 || bw > 256) return false;
  if (static_cast<long long>(bd) * bh * bw != bm) return false;
  if (bn != 32 && bn != 64 && bn != 128 && bn != 160 && bn != 256) return false;
  if (stages < 3 || stages > MAX_STAGES) return false;
  p.kc1 = (p.ci1 + KC - 1) / KC;
  p.kc2 = (p.ci2 + KC - 1) / KC;
  if (smem != smem_bytes(bm, bn, stages, p.kc1, p.kc2, stage) || smem > SMEM_LIMIT) return false;
  p.tiles_h = (p.H + bh - 1) / bh;
  p.tiles_w = (p.W + bw - 1) / bw;
  p.col_tiles = (p.co + bn - 1) / bn;
  *grid_x = static_cast<long long>((p.d_hi - p.d_lo + bd - 1) / bd) * p.tiles_h * p.tiles_w *
            p.col_tiles;
  return *grid_x > 0 && *grid_x <= 0x7fffffffLL;
}

// Calls f.template run<BN, NC>() for the plan's bn and bm (NC = bm / 64;
// four consumer warpgroups only for BN <= 64).
template <int BN, typename F>
inline int dispatch_rows(int bm, const F& f) {
  if constexpr (BN <= 64) {
    if (bm == 256) return f.template run<BN, 4>();
  }
  return bm == 128 ? f.template run<BN, 2>() : f.template run<BN, 1>();
}

template <typename F>
inline int dispatch(int bn, int bm, const F& f) {
  switch (bn) {
    case 32: return dispatch_rows<32>(bm, f);
    case 64: return dispatch_rows<64>(bm, f);
    case 128: return dispatch_rows<128>(bm, f);
    case 160: return dispatch_rows<160>(bm, f);
    case 256: return dispatch_rows<256>(bm, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Raise the kernel's dynamic shared-memory limit, then launch; returns the
// first error of the two.
template <typename Kernel, typename... A>
inline int launch(Kernel kernel, dim3 grid, int threads, long long smem, cudaStream_t stream,
                  A... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, static_cast<size_t>(smem), stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv3d_wgmma
