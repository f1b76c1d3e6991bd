// 2x2x2 stride-2 transposed convolution without bias on NDHWC bf16, f32
// accumulation, bf16 output, the pixel shuffle written by the epilogue --
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel braintpu/ops/upconv_pallas.py::upconv2x (bodies
// `_kernel` and `_kernel_lanes`), which computes the same function:
//   out[n, 2d+kd, 2h+kh, 2w+kw, c] = sum_ci x[n, d, h, w, ci] * w[ci, kd, kh, kw, c].
// Python wrapper: braintpu_torch/ops/upconv.py; launch plan:
// braintpu_torch/ops/upconv_plan.py.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s HBM).  Per input
// voxel the kernel does 2*ci*8*co flops and moves 2*ci bytes in and
// 16*co bytes out: 51-235 flops per byte on the two models' up-convs,
// below the card's ~295, so every shape is bound by bytes, mostly by the
// output (8x the input's voxels).  The level-0 up-conv of the GroupNorm
// model at the 224x224x128 bucket (112x112x64x64 -> 224x224x128x64) moves
// 0.925 GB: 0.276 ms at 3.35 TB/s.  So the design reads x once, writes
// each output byte once in whole runs, and keeps the products off the
// critical path.
//
// GEMM view (the reference's "lanes" layout): M = input voxels, K = ci,
// N = 8*co with column j = ((kd*2 + kh)*2 + kw)*co + c.  For a fixed phase
// pair (kd, kh) the 2*co columns (kw, c) of a row are one contiguous run of
// the output, so the output is the 5-D view
//   (2co [kw,c], W [w], 2 [kh], H [h], N*2D [2(n*D + d) + kd])
// of (N, 2D, 2H, 2W, co), and a tile's result for one phase pair is one
// box of that view.
//
// Design: a persistent, warp-specialised block on one SM.
//   * Tiles: bh x bw input voxels of one (n, d) slice, at most 64 (whole W
//     rows when W <= 64).  Block b serves column group b % splits and
//     walks its tiles with a static stride; its tiles go in turn to NC = 2
//     consumer warpgroups.
//   * Warpgroup 0 is the producer: one thread first loads the group's
//     weights by TMA (resident: the B columns of sg slices of nb columns,
//     N-major as stored, for every K chunk) and then keeps a ring of
//     `stages` A tiles full: one 4-D TMA box (64 c x bw x bh x 1) per
//     64-channel chunk, 128-byte swizzle, zeros past ci and past the
//     volume.  full/empty mbarriers hand the tiles over; x is read once
//     per column group (once when the whole B fits).  `stages` is a
//     multiple of NC, so a stage always serves the same consumer and its
//     parity waits come in order.
//   * Each consumer warpgroup runs, per tile and slice, wgmma m64nNBk16
//     (both operands from shared memory; B through the descriptor's
//     transpose bit, as conv3d_wgmma.cuh reads its weights), rounds the f32
//     accumulators to bf16 into a 128-byte-swizzled staging buffer laid
//     out as the output box (conflict-free), and one thread stores it by
//     TMA (cp.async.bulk.tensor shared -> global, 64-column boxes, L2
//     evict-first: the output is not read back by this kernel).  Two
//     staging buffers per consumer: a slice's store overlaps the next
//     slice's products; `wait_group.read` guards a buffer's reuse.  Ragged
//     H, W and run edges are clipped by the output map's bounds.  On the
//     large shapes the SM's TMA unit, which carries both the tile loads and
//     these stores, paces the loop: the kernel writes at 2.5-2.7 TB/s on
//     an H100 80GB HBM3 at 700 W (PERF.md).
//   * Streamed mode (no model shape: ci too large for one resident slice
//     beside two A tiles): each ring stage holds one 64-channel chunk of A
//     and of one slice's B, and consumer 0 takes every tile.
// The plan (tile, nb, sg, stages, streamed, shared memory, grid) comes from
// upconv_plan.py and is checked here; the shared-memory layout must match
// its upconv_plan_smem_bytes().
//
// Contract (checked by the wrapper): x (N,D,H,W,ci) bf16 contiguous,
// w (ci,2,2,2,co) bf16 contiguous (read as (ci, 8*co)), y (N,2D,2H,2W,co)
// bf16 allocated by the caller; ci % 8 == 0, co % 8 == 0, 16-byte aligned
// pointers.  The kernel allocates nothing and runs on the caller's stream.

#include "conv3d_wgmma.cuh"

namespace {

using namespace conv3d_wgmma;

constexpr int ROWS = 64;                // input voxels per tile
constexpr int NC = 2;                   // consumer warpgroups
constexpr int BUFS = 2;                 // staging buffers per consumer
constexpr int THREADS = 128 * (1 + NC);
constexpr int CHUNK = ROWS * ROW_BYTES;  // one tile's 64-channel chunk: 8 KiB
constexpr int UP_MAX_STAGES = 6;

struct UpArgs {
  int N, D, H, W, ci, co;
  int kc, sp, slices, sg, splits, stages;
  int bh, bw, th, tw;
  long long tiles;
};

// Shared-memory bytes of a plan; ops/upconv_plan.py computes the same.
inline long long up_smem_bytes(int kc, int nb, int sg, int stages, bool stream) {
  long long b = ALIGN_SLACK + static_cast<long long>(BUFS) * NC * nb * 128 + (2LL * stages + 1) * 8;
  if (stream) return b + static_cast<long long>(stages) * (CHUNK + nb * 128);
  return b + static_cast<long long>(sg) * kc * nb * 128 + static_cast<long long>(stages) * kc * CHUNK;
}

template <int NB, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
    upconv2x_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                    const __grid_constant__ CUtensorMap my, const UpArgs p) {
  constexpr int NACC = NB / 2;
  constexpr int BCHUNK = NB * ROW_BYTES;  // one slice's B for one 64-channel chunk
  constexpr int STG = ROWS * NB * 2;      // one staging buffer
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = p.stages;
  const int slot_bytes = STREAM ? CHUNK + BCHUNK : p.kc * CHUNK;
  uint8_t* sB = smem;  // resident weights
  uint8_t* sA = sB + (STREAM ? 0 : p.sg * p.kc * BCHUNK);
  uint8_t* sC = sA + S * slot_bytes;  // staging, BUFS buffers per consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + BUFS * NC * STG);
  uint64_t* empty = full + S;
  uint64_t* bfull = empty + S;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int grp = blockIdx.x % p.splits;
  const int first = blockIdx.x / p.splits;
  const int cnt = gridDim.x / p.splits + (grp < static_cast<int>(gridDim.x % p.splits) ? 1 : 0);
  const int s0 = grp * p.sg;
  const int sgc = min(p.sg, p.slices - s0);
  const int takers = STREAM ? 1 : NC;  // consumer warpgroups that take tiles
  const int reps = STREAM ? sgc * p.kc : 1;  // ring stages per tile
  const uint32_t a_box = static_cast<uint32_t>(p.bh * p.bw * ROW_BYTES);
  const int per_slice = p.th * p.tw;
  auto col0 = [&](int gs) { return (gs / p.sp) * 2 * p.co + (gs % p.sp) * NB; };
  // The block's k-th tile, -1 past its last: a static stride over the tiles
  // (neighbouring blocks on neighbouring tiles)
  auto tile_at = [&](long long k) -> long long {
    const long long t = first + k * cnt;
    return t < p.tiles ? t : -1;
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init(smem_u32(bfull), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread -------------------------------------------
    if (tid == 0) {
      if (!STREAM) {
        const uint32_t bb = smem_u32(bfull);
        mbar_expect_tx(bb, static_cast<uint32_t>(sgc * p.kc * BCHUNK));
        for (int s = 0; s < sgc; ++s)
          for (int q = 0; q < p.kc; ++q)
#pragma unroll
            for (int i = 0; i < NB / B_BOX; ++i)
              tma_load_2d(smem_u32(sB + (s * p.kc + q) * BCHUNK + i * B_BOX * ROW_BYTES), &mw,
                          bb, col0(s0 + s) + i * B_BOX, q * KC);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (long long k = 0;; ++k) {
        const long long t = tile_at(k);
        if (t < 0) break;
        const int nd = static_cast<int>(t / per_slice);
        const int rem = static_cast<int>(t % per_slice);
        const int h0 = rem / p.tw * p.bh, w0 = rem % p.tw * p.bw;
        for (int r = 0; r < reps; ++r) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t fb = smem_u32(&full[stage]);
          uint8_t* slot = sA + stage * slot_bytes;
          if (STREAM) {
            const int s = r / p.kc, q = r % p.kc;
            mbar_expect_tx(fb, a_box + BCHUNK);
            tma_load_4d(smem_u32(slot), &mx, fb, q * KC, w0, h0, nd);
#pragma unroll
            for (int i = 0; i < NB / B_BOX; ++i)
              tma_load_2d(smem_u32(slot + CHUNK + i * B_BOX * ROW_BYTES), &mw, fb,
                          col0(s0 + s) + i * B_BOX, q * KC);
          } else {
            mbar_expect_tx(fb, p.kc * a_box);
            for (int q = 0; q < p.kc; ++q)
              tma_load_4d(smem_u32(slot + q * CHUNK), &mx, fb, q * KC, w0, h0, nd);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  const int c = wg - 1;
  if (c >= takers) return;
  const int ctid = tid & 127;
  const int warp = ctid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  uint8_t* stg = sC + c * BUFS * STG;
  const uint64_t policy = l2_evict_first();  // the output streams through L2
  if (!STREAM) mbar_wait(smem_u32(bfull), 0);
  float acc[NACC];
  int stores = 0;
  for (long long k = c;; k += takers) {  // k: the block's own tile index
    const long long t = tile_at(k);
    if (t < 0) break;
    const int nd = static_cast<int>(t / per_slice);
    const int rem = static_cast<int>(t % per_slice);
    const int h0 = rem / p.tw * p.bh, w0 = rem % p.tw * p.bw;
    for (int s = 0; s < sgc; ++s) {
      // the slice's first product overwrites acc (scale-d = 0): no zeroing
      // instructions among the wgmmas, which ptxas would serialise
      if (STREAM) {
        for (int q = 0; q < p.kc; ++q) {
          const long long idx = k * reps + s * p.kc + q;
          const int st = static_cast<int>(idx % S);
          mbar_wait(smem_u32(&full[st]), static_cast<uint32_t>((idx / S) & 1));
          const uint32_t base = smem_u32(sA + st * slot_bytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            wgmma_ss<NB>(acc, desc_a(base + kk * 32), desc_b(base + CHUNK + kk * 16 * 64),
                         q > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
        }
      } else {
        const int st = static_cast<int>(k % S);
        if (s == 0) mbar_wait(smem_u32(&full[st]), static_cast<uint32_t>((k / S) & 1));
        const uint32_t a_base = smem_u32(sA + st * slot_bytes);
        const uint32_t b_base = smem_u32(sB + s * p.kc * BCHUNK);
        wgmma_fence();
        for (int q = 0; q < p.kc; ++q) {
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            wgmma_ss<NB>(acc, desc_a(a_base + q * CHUNK + kk * 32),
                         desc_b(b_base + q * BCHUNK + kk * 16 * 64), q > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if (s == sgc - 1 && lane == 0) mbar_arrive(smem_u32(&empty[st]));
      }

      // ---- epilogue: acc[4j + 2i + e] is row 16 warp + g + 8i, column
      // 8j + 2 t4 + e.  The staging buffer holds NB/64 boxes of 64 rows x
      // 128 bytes, 16-byte chunk q of row r at (q ^ (r & 7)): TMA's
      // 128-byte swizzle, and no bank conflict for the 8 rows of a warp.
      uint8_t* buf = stg + (stores % BUFS) * STG;
      if (ctid == 0) bulk_wait_read<BUFS - 1>();  // the store that last read `buf` is done with it
      named_barrier(1 + c, 128);
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + g + 8 * i;
          const int off = (j >> 3) * (ROWS * ROW_BYTES) + r * ROW_BYTES +
                          (((j & 7) ^ (r & 7)) << 4) + 4 * t4;
          *reinterpret_cast<__nv_bfloat162*>(buf + off) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
      fence_proxy_async();
      named_barrier(1 + c, 128);
      if (ctid == 0) {
        const int gs = s0 + s;
        const int ph = gs / p.sp, j0 = (gs % p.sp) * NB;
#pragma unroll
        for (int b = 0; b < NB / 64; ++b) {
          if (j0 + 64 * b < 2 * p.co)
            tma_store_5d(&my, smem_u32(buf + b * ROWS * ROW_BYTES), j0 + 64 * b, w0, ph & 1, h0,
                         2 * nd + (ph >> 1), policy);
        }
        bulk_commit();
      }
      ++stores;
    }
  }
  if (ctid == 0) bulk_wait_all();
}

// 4-D map of x viewed (N*D, H, W, ci): box 64 c x bw x bh x 1, 128-byte
// swizzle, zeros outside.
bool encode_x(CUtensorMap* m, const void* x, int N, int D, int H, int W, int ci, int bh, int bw) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = 2;
  cuuint64_t dims[4] = {(cuuint64_t)ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N * D};
  cuuint64_t strides[3] = {ci * e, (cuuint64_t)W * ci * e, (cuuint64_t)H * W * ci * e};
  cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 2-D map (8co, ci) of the weights as stored: box 32 columns x 64 c,
// 64-byte swizzle (the layout desc_b reads), zeros past ci and 8co.
bool encode_w(CUtensorMap* m, const void* w, int ci, int co) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)8 * co, (cuuint64_t)ci};
  cuuint64_t strides[1] = {(cuuint64_t)16 * co};
  cuuint32_t box[2] = {(cuuint32_t)B_BOX, (cuuint32_t)KC};
  cuuint32_t one[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 5-D map of y viewed (2co, W, 2, H, N*2D) (the lanes view): box 64 columns
// x bw x 1 x bh x 1, 128-byte swizzle; stores clip at its bounds.
bool encode_y(CUtensorMap* m, void* y, int N, int D, int H, int W, int co, int bh, int bw) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t c = static_cast<cuuint64_t>(co) * 2;  // bytes of co bf16
  cuuint64_t dims[5] = {(cuuint64_t)2 * co, (cuuint64_t)W, 2, (cuuint64_t)H, (cuuint64_t)2 * N * D};
  cuuint64_t strides[4] = {2 * c, 2 * W * c, 4 * W * c, 4ull * H * W * c};
  cuuint32_t box[5] = {64, (cuuint32_t)bw, 1, (cuuint32_t)bh, 1};
  cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, y, dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Fill the plan fields of `p` from the host's plan and check it; false on
// a plan this code cannot take.
bool up_plan_ok(UpArgs& p, int bh, int bw, int nb, int sg, int stages, bool stream,
                long long smem, int grid) {
  if (p.N <= 0 || p.D <= 0 || p.H <= 0 || p.W <= 0 || p.ci <= 0 || p.co <= 0) return false;
  if (p.ci % 8 || p.co % 8 || 2LL * p.N * p.D > 0x7fffffffLL) return false;
  if (bh < 1 || bw < 1 || bh * bw > ROWS || bh > p.H || bw > p.W) return false;
  if (nb != 64 && nb != 128) return false;
  // with resident B each stage serves one consumer: stages % NC == 0
  if (stages < 2 || stages > UP_MAX_STAGES || (!stream && stages % NC)) return false;
  p.kc = (p.ci + KC - 1) / KC;
  p.sp = (2 * p.co + nb - 1) / nb;
  p.slices = 4 * p.sp;
  if (sg < 1 || sg > p.slices || (stream && sg != 1)) return false;
  p.sg = sg;
  p.splits = (p.slices + sg - 1) / sg;
  p.stages = stages;
  p.bh = bh, p.bw = bw;
  p.th = (p.H + bh - 1) / bh;
  p.tw = (p.W + bw - 1) / bw;
  p.tiles = static_cast<long long>(p.N) * p.D * p.th * p.tw;
  if (p.tiles > 0x7fffffffLL || grid < p.splits) return false;
  return smem == up_smem_bytes(p.kc, nb, sg, stages, stream) && smem <= SMEM_LIMIT;
}

// Launch one instantiation; its dynamic shared-memory limit is raised to
// the card's maximum on its first launch only (the call costs host time).
template <int NB, bool STREAM>
int start(dim3 grid, long long smem, cudaStream_t stream, const CUtensorMap& mx,
          const CUtensorMap& mw, const CUtensorMap& my, const UpArgs& p) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(upconv2x_kernel<NB, STREAM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  upconv2x_kernel<NB, STREAM><<<grid, THREADS, static_cast<size_t>(smem), stream>>>(mx, mw, my, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an integer handle).  `a`
// holds the shape and the plan of upconv_plan.py:
//   N, D, H, W, ci, co, bh, bw, nb, sg, stages, streamed, smem, grid
// (UpconvPlan.launch_args() after the shape).  Returns cudaGetLastError()
// as an int: 0 when the launch was accepted, cudaErrorInvalidValue for a
// plan it cannot take.
extern "C" int upconv2x_launch(const void* x, const void* w, void* y, const long long* a,
                               void* stream) {
  UpArgs p = {};
  for (int i = 0; i < 14; ++i)
    if (a[i] < 0 || a[i] > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.N = (int)a[0], p.D = (int)a[1], p.H = (int)a[2], p.W = (int)a[3], p.ci = (int)a[4], p.co = (int)a[5];
  const int bh = (int)a[6], bw = (int)a[7], nb = (int)a[8], sg = (int)a[9], stages = (int)a[10];
  const bool streamed = a[11] != 0;
  const long long smem = a[12];
  const int grid = (int)a[13];
  if (!up_plan_ok(p, bh, bw, nb, sg, stages, streamed, smem, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw, my;
  if (!encode_x(&mx, x, p.N, p.D, p.H, p.W, p.ci, bh, bw) || !encode_w(&mw, w, p.ci, p.co) ||
      !encode_y(&my, y, p.N, p.D, p.H, p.W, p.co, bh, bw))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid));
  if (nb == 64)
    return streamed ? start<64, true>(g, smem, s, mx, mw, my, p)
                    : start<64, false>(g, smem, s, mx, mw, my, p);
  return streamed ? start<128, true>(g, smem, s, mx, mw, my, p)
                  : start<128, false>(g, smem, s, mx, mw, my, p);
}
