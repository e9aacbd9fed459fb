// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubeshare_tpu/ops/attention.py
// _flash_kernel (launched by _flash_forward): causal / sliding-window /
// grouped-query attention with an online softmax, returning the output
// and the row log-sum-exp. Its plain PyTorch version is
// flash_attention_reference in ../attention.py.
//
// Layout. q [B*H, Tq, D], k/v [B*Hkv, Tk, D], out like q, lse [B*H, Tq]
// float32, all contiguous and 16-byte aligned. The kv head of query head
// bh is (bh / H) * Hkv + (bh % H) / (H / Hkv), so K/V are never repeated.
// A block loops over the key tiles its queries can see (the causal
// diagonal and the window bound the loop, so dead tiles are never loaded:
// key_range for float32, the host's work list for bf16); that loop
// replaces the Pallas grid's sequential third axis.
// Ragged edges: rows past Tq are computed on zeros and not written, keys
// past Tk arrive as zeros and are masked.
//
// Numerics kept from _flash_kernel: products of input-dtype values summed
// in float32; float32 running max, sum and accumulator; -1e30 (not -inf)
// for masked scores; P rounded to the input dtype before the PV product
// (its row sum taken before the rounding); l = max(l, 1e-30);
// lse = m + log(l). Causal rows align to the end of the keys (query i is
// at position i + Tk - Tq; the wrapper requires Tq <= Tk). No atomics:
// two launches give the same bits.
//
// What bounds it on the H100. At the Llama-3-8B shape (B=1, H=32, Hkv=8,
// T=2048, D=128, causal, bf16) the work is ~34.4 GFLOP against ~42 MB of
// traffic: ~35 us at 989 TFLOP/s of bf16 tensor-core peak, ~13 us at
// 3.35 TB/s. It is bound by operations, and on Hopper only wgmma reaches
// that peak. The mma.sync kernel this one replaced reached 140 TFLOP/s:
// 4 warps of 16 rows (206 registers, 2 blocks an SM) ran each product
// and then its softmax in turn, every thread spent registers and
// instructions on cp.async addresses, and each 64-row q tile re-read its
// K/V tiles from L2.
//
// The bf16 kernel (flash_fwd_bf16) is warp-specialised, after
// FlashAttention-3:
// - 128 query rows a work item, held by two consumer warpgroups of 64
//   rows; each K/V tile read from L2 serves all 128 (half the re-reads of
//   64-row tiles).
// - A producer warp starts TMA loads (3-D tensor maps, so rows past a
//   ragged T are zero-filled inside their own head) of Q once an item and
//   of 128-key K and V tiles into a ring of FWD_STAGES stages, with
//   mbarriers: K and V have their own full and empty barriers, so S can
//   start before V lands and a K tile is released once S is done. It gives
//   up registers (setmaxnreg) to the consumers, whose float32 accumulators
//   (S: 64 x 128, O: 64 x D a warpgroup) then fit without spills.
// - S = Q K^T is a wgmma with both operands in swizzled shared memory
//   (64-column boxes with the 128-byte swizzle at D = 64 and 128, one
//   32-column box with the 64-byte swizzle at D = 32, one 16-column box
//   with the 32-byte swizzle at D = 16, where S is a single k16 step and
//   P V an m64n16k16 product; hopper.cuh Tile);
//   O += P V a wgmma (N = D) with P from registers (the S accumulator's
//   layout is the A fragment's, so P is packed to bf16 in place) and V
//   MN-major from shared memory (the transpose bit).
// - Overlap inside a warpgroup: S of tile j and P V of tile j - 1 are
//   started together, and the softmax of tile j runs while P V is still on
//   the tensor cores. Between the two warpgroups a ping-pong of named
//   barriers hands the tensor cores to one while the other runs its
//   softmax.
// - The softmax works on unscaled scores: each exponential is one FFMA
//   (scale log2 e folded in) and one ex2.approx; the per-element mask runs
//   only on tiles some (row, key) pair of which is hidden.
// - Persistent grid, one block per SM, over (b*h, q tile) work items.
//   The host deals them (flash_forward_schedule in ../attention.py:
//   longest first, in a snake, so each block's total work is about even)
//   and passes the list; a block walks its share of it, and one item's
//   epilogue overlaps the next item's loads.
// Variants were timed against each other in one call on an H100 (PERF.md
// section 6): the overlap, the ping-pong and the FFMA softmax each made
// the 8B shape faster; 64-key tiles were slower; a 3-stage ring was a few
// per cent faster at T = 2048 and as much slower at T = 4096, so the ring
// keeps 2; one block per item was slower at B = 4 and T = 4096.
// float32 inputs have no tensor-core path with float32 products (TF32
// would change the numbers), so flash_fwd_f32 does them with FMAs on the
// CUDA cores (67 TFLOP/s peak).
// Head dims: instances for 16, 32, 64 and 128, bf16 and float32. The
// wrapper (../attention.py) zero-pads any other head dim up to 128 to the
// next of these and slices the output back; zero columns add nothing to
// Q K^T, and V's give zero output columns.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ---- bf16: TMA ring, wgmma, warp-specialised consumers ----------------

constexpr int FWD_BM = 128;         // query rows per block
constexpr int FWD_THREADS = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int FWD_CONSUMERS = 256;  // threads of the consumer warpgroups
constexpr int FWD_BN = 128;         // keys per K/V tile
constexpr int FWD_STAGES = 2;       // depth of the K/V ring

// Tiles as Tile<D>::BOXES column boxes of [rows][COLS] bf16 (hopper.cuh);
// every box is a multiple of 8 rows, so all start on the swizzle's period.
// K and V of a stage have their own full and empty barriers: a K tile is
// released as soon as its S product is done.
template <int D>
struct FwdSmem {
  using Tl = Tile<D>;
  __nv_bfloat16 q[Tl::BOXES][FWD_BM * Tl::COLS];
  __nv_bfloat16 k[FWD_STAGES][Tl::BOXES][FWD_BN * Tl::COLS];
  __nv_bfloat16 v[FWD_STAGES][Tl::BOXES][FWD_BN * Tl::COLS];
  uint64_t full_q, empty_q, full_k[FWD_STAGES], full_v[FWD_STAGES];
  uint64_t empty_k[FWD_STAGES], empty_v[FWD_STAGES];
};

// Ping-pong of the two consumer warpgroups (named barriers 1 and 2, each of
// both warpgroups' 256 threads): a warpgroup waits for its turn before it
// starts its products and hands the turn over once they are started, so one
// warpgroup's softmax runs while the other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(FWD_CONSUMERS)
               : "memory");
}

__device__ __forceinline__ void turn_pass(int wg, bool last = false) {
  // warpgroup 1 passed first, so its last turn is not passed on: every
  // sync then meets one arrival and no barrier is left half-way at exit
  if (!(last && wg == 1))
    asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(FWD_CONSUMERS)
                 : "memory");
}

// One consumer warpgroup: 64 query rows of the block, their running max
// (of the unscaled scores), this thread's share of their row sums, and the
// products and softmax of one key tile.
template <int D>
struct FwdRows {
  static constexpr int NS = FWD_BN / 2;  // score accumulators a thread
  static constexpr int NO = D / 2;       // output accumulators a thread
  using Tl = Tile<D>;
  FwdSmem<D>& sm;
  int wg, qpos0, qpos1, first, last, t_k, causal, window;
  float scale_log2;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float c0 = 0.f, c1 = 0.f;  // rescale of O from the latest softmax

  // S = Q K^T of the tile in `stage`, started, not committed
  __device__ __forceinline__ void start_qk(float (&s)[NS], int stage) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // k step kk: 16 columns, 32 bytes a step into box kk / KSTEPS
      const int box = kk / Tl::KSTEPS, col = (kk % Tl::KSTEPS) * 16;
      const uint64_t a =
          k_desc<D>(sm.q[box] + wg * 64 * Tl::COLS + col);
      const uint64_t b = k_desc<D>(sm.k[stage][box] + col);
      WgmmaSS<FWD_BN>::run(s, a, b, kk > 0);
    }
  }

  // O += P V of the tile in `stage`, started, not committed
  __device__ __forceinline__ void start_pv(float (&o)[NO],
                                           const uint32_t (&pf)[NS / 8][4],
                                           int stage) {
#pragma unroll
    for (int kk = 0; kk < FWD_BN / 16; ++kk) {
      // keys 16 kk .. 16 kk + 15: 16 rows into each box; the next COLS
      // output columns one box (FWD_BN rows) on
      const uint64_t b = mn_desc<D>(sm.v[stage][0] + kk * 16 * Tl::COLS,
                                    FWD_BN * Tl::ROW_BYTES);
      WgmmaRS<D>::run(o, pf[kk], b);
    }
  }

  // Mask, new row max, the rescale c of O and l, and P = e^(scale (S - m))
  // in place of S (float32), for the tile of keys at k0. Masked scores are
  // -1e30 before the scale, which keeps them far below any real one.
  __device__ __forceinline__ void softmax(float (&s)[NS], int k0, int tig) {
    // the per-element mask only where some (row, key) pair of the tile is
    // hidden: the diagonal, the window's edge, the ragged end
    const bool whole = k0 + FWD_BN <= t_k &&
                       (!causal || (k0 + FWD_BN - 1 <= first &&
                                    (window <= 0 || k0 > last - window)));
    if (!whole) {
#pragma unroll
      for (int j = 0; j < FWD_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + 2 * tig + e;
          if (!visible(qpos0, kpos, t_k, causal, window)) s[4 * j + e] = NEG_INF;
          if (!visible(qpos1, kpos, t_k, causal, window))
            s[4 * j + 2 + e] = NEG_INF;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < FWD_BN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // a row's scores sit in the 4 lanes of a quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    c0 = exp2_approx((m0 - mx0) * scale_log2);
    c1 = exp2_approx((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    // 2^(scale log2(e) (s - m)) as one FFMA and one ex2. A row that has
    // seen only masked keys subtracts 0: its P is then 0 where the
    // reference's is 1, and either is wiped by the next real key's
    // rescale (c = 0) before anything reaches the output.
    const float b0 = m0 == NEG_INF ? 0.f : m0 * scale_log2;
    const float b1 = m1 == NEG_INF ? 0.f : m1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < FWD_BN / 8; ++j) {
      s[4 * j] = exp2_approx(fmaf(s[4 * j], scale_log2, -b0));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -b0));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -b1));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -b1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  }

  // P rounded to bf16 as the A fragments of the PV product: k step kk
  // takes the accumulator's 8-column chunks 2 kk and 2 kk + 1
  __device__ __forceinline__ static void pack(const float (&s)[NS],
                                              uint32_t (&pf)[NS / 8][4]) {
#pragma unroll
    for (int j = 0; j < FWD_BN / 8; ++j) {
      pf[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);  // row g
      pf[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(s[4 * j + 2], s[4 * j + 3]);  // row g + 8
    }
  }

  __device__ __forceinline__ void rescale(float (&o)[NO]) const {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
  }
};

using FwdRing = Ring<FWD_STAGES>;  // the K/V ring

// One work item of the host's list: query head bh, its FWD_BM-row q tile
// at q0, and the keys [lo, hi) its rows can see (lo a multiple of FWD_BN).
// The list is int32: G + 1 offsets (block b takes items offsets[b] to
// offsets[b + 1] - 1, in that order), then four ints an item.
struct FwdItem {
  int bh, q0, lo, hi;
};

__device__ __forceinline__ FwdItem fwd_item(const int* __restrict__ items,
                                            int i) {
  const int* p = items + 4 * i;
  return {p[0], p[1], p[2], p[3]};
}

// One work item for the two consumer warpgroups: each owns 64 query rows.
// Each step starts S of tile j and P V of tile j - 1 together and runs the
// softmax of tile j while P V is still on the tensor cores.
template <int D>
__device__ __forceinline__ void fwd_consume(
    FwdSmem<D>& sm, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    const FwdItem& it, int t_q, int t_k, int causal, float scale_log2,
    int window, FwdRing& ring, bool final_item) {
  using Rows = FwdRows<D>;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int offset = causal ? t_k - t_q : 0;
  const int row0 = it.q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
  const int wg_row = it.q0 + wg * 64;
  Rows rows{sm,
            wg,
            row0 + offset,
            row1 + offset,
            wg_row + offset,
            min(wg_row + 64, t_q) - 1 + offset,
            t_k,
            causal,
            window,
            scale_log2};

  float o[Rows::NO];
#pragma unroll
  for (int i = 0; i < Rows::NO; ++i) o[i] = 0.f;
  float s[Rows::NS];
  uint32_t pf[Rows::NS / 8][4];
  const int n_tiles = (it.hi - it.lo + FWD_BN - 1) / FWD_BN;
  int k0 = it.lo;
  FwdRing cur = ring;  // tile j - 1, whose V is pending
  mbar_wait(&sm.full_k[cur.stage], cur.phase);
  turn_wait(wg);
  wgmma_fence();
  rows.start_qk(s, cur.stage);
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  release(&sm.empty_k[cur.stage], lane);
  rows.softmax(s, k0, tig);
  Rows::pack(s, pf);
  for (int j = 1; j < n_tiles; ++j) {
    FwdRing next = cur;
    next.advance();
    k0 += FWD_BN;
    rows.rescale(o);
    mbar_wait(&sm.full_k[next.stage], next.phase);
    turn_wait(wg);
    wgmma_fence();
    rows.start_qk(s, next.stage);
    wgmma_commit();
    mbar_wait(&sm.full_v[cur.stage], cur.phase);
    rows.start_pv(o, pf, cur.stage);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();  // S is done; P V may still run
    fence_regs(s);
    release(&sm.empty_k[next.stage], lane);
    rows.softmax(s, k0, tig);
    wgmma_wait<0>();
    fence_regs(o);
    release(&sm.empty_v[cur.stage], lane);
    Rows::pack(s, pf);
    cur = next;
  }
  rows.rescale(o);
  mbar_wait(&sm.full_v[cur.stage], cur.phase);
  turn_wait(wg);
  wgmma_fence();
  rows.start_pv(o, pf, cur.stage);
  wgmma_commit();
  turn_pass(wg, final_item);
  wgmma_wait<0>();
  fence_regs(o);
  release(&sm.empty_v[cur.stage], lane);
  release(&sm.empty_q, lane);  // Q may be refilled for the next item
  ring = cur;
  ring.advance();

  float l0 = rows.l0, l1 = rows.l1;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const float m_scale = 0.6931471805599453f * scale_log2;  // = scale
  __nv_bfloat16* op = out + (size_t)it.bh * t_q * D;
  if (row0 < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row0 * D + j * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (tig == 0) lse[(size_t)it.bh * t_q + row0] = rows.m0 * m_scale + logf(l0);
  }
  if (row1 < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row1 * D + j * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    if (tig == 0) lse[(size_t)it.bh * t_q + row1] = rows.m1 * m_scale + logf(l1);
  }
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   const int* __restrict__ work, int heads, int kv_heads,
                   int t_q, int t_k, int causal, float scale_log2,
                   int window) {
  using Tl = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D>& sm = aligned_smem<FwdSmem<D>>(smem_raw);
  const int begin = work[blockIdx.x], end = work[blockIdx.x + 1];
  const int* items = work + gridDim.x + 1;

  if (threadIdx.x == 0) {
    mbar_init(&sm.full_q, 1);
    mbar_init(&sm.empty_q, FWD_CONSUMERS / 32);  // one per consumer warp
#pragma unroll
    for (int i = 0; i < FWD_STAGES; ++i) {
      mbar_init(&sm.full_k[i], 1);
      mbar_init(&sm.full_v[i], 1);
      mbar_init(&sm.empty_k[i], FWD_CONSUMERS / 32);
      mbar_init(&sm.empty_v[i], FWD_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= FWD_CONSUMERS) {
    // producer warpgroup: one thread starts every load
    regs_dealloc<40>();
    if (threadIdx.x == FWD_CONSUMERS) {
      constexpr uint32_t KV_BYTES = FWD_BN * D * sizeof(__nv_bfloat16);
      FwdRing ring;
      for (int i = begin; i < end; ++i) {
        const FwdItem it = fwd_item(items, i);
        const int kvh = (it.bh / heads) * kv_heads +
                        (it.bh % heads) / (heads / kv_heads);
        // Q of the previous item released (the first passes)
        mbar_wait(&sm.empty_q, ((i - begin) & 1) ^ 1);
        mbar_expect_tx(&sm.full_q, FWD_BM * D * sizeof(__nv_bfloat16));
#pragma unroll
        for (int h = 0; h < Tl::BOXES; ++h)
          tma_load_3d(sm.q[h], &q_map, &sm.full_q, h * Tl::COLS, it.q0,
                      it.bh);
        for (int k0 = it.lo; k0 < it.hi; k0 += FWD_BN) {
          // a stage is free once both warpgroups released it; the first
          // round passes
          mbar_wait(&sm.empty_k[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&sm.full_k[ring.stage], KV_BYTES);
#pragma unroll
          for (int h = 0; h < Tl::BOXES; ++h)
            tma_load_3d(sm.k[ring.stage][h], &k_map, &sm.full_k[ring.stage],
                        h * Tl::COLS, k0, kvh);
          mbar_wait(&sm.empty_v[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&sm.full_v[ring.stage], KV_BYTES);
#pragma unroll
          for (int h = 0; h < Tl::BOXES; ++h)
            tma_load_3d(sm.v[ring.stage][h], &v_map, &sm.full_v[ring.stage],
                        h * Tl::COLS, k0, kvh);
          ring.advance();
        }
      }
    }
  } else {
    regs_alloc<232>();
    const int wg = threadIdx.x / 128;
    if (wg == 1) turn_pass(wg);  // warpgroup 0 starts first
    FwdRing ring;
    for (int i = begin; i < end; ++i) {
      mbar_wait(&sm.full_q, (i - begin) & 1);
      fwd_consume<D>(sm, out, lse, fwd_item(items, i), t_q, t_k, causal,
                     scale_log2, window, ring, i + 1 == end);
    }
  }
}

// ---- float32: CUDA-core FMAs -----------------------------------------

template <int D>
constexpr size_t f32_smem_floats() {
  return (size_t)D * LDQ      // q tile, transposed [D][LDQ]
         + (size_t)D * LDK    // k tile, transposed [D][LDK]
         + (size_t)BK * D     // v tile [BK][D]
         + (size_t)BK * LDQ;  // p tile, transposed [BK][LDQ]
}

// Each thread owns a 4x4 score micro-tile and a 4x(D/16) output
// micro-tile with interleaved columns, so shared-memory reads are
// conflict-free or broadcasts.
template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int heads, int kv_heads, int t_q,
                  int t_k, int causal, float scale, int window) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + D * LDQ;
  float* vs = ks + D * LDK;
  float* ps = vs + BK * D;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / (heads / kv_heads);
  const float* qp = q + (size_t)bh * t_q * D;
  const float* kp = k + (size_t)kvh * t_k * D;
  const float* vp = v + (size_t)kvh * t_k * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty + 16*i
  const int tx = tid % 16;  // score columns tx + 16*j, out columns tx + 16*c

  for (int idx = tid; idx < BQ * D; idx += FMA_THREADS) {
    const int r = idx / D, d = idx % D;
    qs[d * LDQ + r] = (q0 + r < t_q) ? qp[(size_t)(q0 + r) * D + d] : 0.f;
  }

  const KeyRange range = key_range(q0, t_q, t_k, causal, window);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = range.lo; k0 < range.hi; k0 += BK) {
    __syncthreads();  // previous tile's readers are done (and q is stored)
    for (int idx = tid; idx < BK * D; idx += FMA_THREADS) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < t_k;
      const size_t at = (size_t)(k0 + r) * D + d;
      ks[d * LDK + r] = in ? kp[at] : 0.f;
      vs[r * D + d] = in ? vp[at] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[d * LDQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[d * LDK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = range.q_first + ty + 16 * i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(qpos, k0 + tx + 16 * j, t_k, causal, window)
                      ? s[i][j] * scale
                      : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // a row's 64 scores sit in the 16 lanes that share ty
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
      const float m_new = fmaxf(m[i], row_max);
      const float correction = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        ps[(tx + 16 * j) * LDQ + ty + 16 * i] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
      l[i] = l[i] * correction + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= correction;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], w[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[kk * LDQ + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) w[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* op = out + ((size_t)bh * t_q + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) op[tx + 16 * c] = acc[i][c] / li;
    if (tx == 0) lse[(size_t)bh * t_q + r] = m[i] + logf(li);
  }
}

// ---- host side -------------------------------------------------------

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           void* out, void* lse, const int* work, int blocks, int batch,
           int heads, int kv_heads, int t_q, int t_k, int causal, float scale,
           int window, cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    if (work == nullptr || blocks <= 0) return (int)cudaErrorInvalidValue;
    CUtensorMap q_map, k_map, v_map;
    if ((err = tensor_map(&q_map, q, D, t_q, batch * heads, FWD_BM)) ||
        (err = tensor_map(&k_map, k, D, t_k, batch * kv_heads, FWD_BN)) ||
        (err = tensor_map(&v_map, v, D, t_k, batch * kv_heads, FWD_BN)))
      return (int)err;
    const size_t smem = smem_bytes<FwdSmem<D>>();
    err = allow_smem(flash_fwd_bf16<D>, smem);
    if (err != cudaSuccess) return (int)err;
    // persistent: the work list is dealt to `blocks` blocks, one an SM
    flash_fwd_bf16<D><<<blocks, FWD_THREADS, smem, stream>>>(
        q_map, k_map, v_map, static_cast<T*>(out), static_cast<float*>(lse),
        work, heads, kv_heads, t_q, t_k, causal, scale * 1.4426950408889634f,
        window);
  } else {
    const dim3 grid((t_q + BQ - 1) / BQ, batch * heads);
    const size_t smem = f32_smem_floats<D>() * sizeof(float);
    err = allow_smem(flash_fwd_f32<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32<D><<<grid, FMA_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), heads, kv_heads, t_q, t_k, causal, scale,
        window);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns 0 or the CUDA error
// of the launch; the caller checks shapes, dtypes, contiguity and
// alignment. bf16 also takes the work list (on the card) dealt to
// `blocks` blocks; float32 ignores both.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, const void* work, int batch,
                         int heads, int kv_heads, int t_q, int t_k,
                         int head_dim, int is_bf16, int causal, float scale,
                         int window, int blocks, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads ||
      t_q <= 0 || t_k <= 0 || batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev = check_device();
  if (dev != cudaSuccess) return (int)dev;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(work);
  if (head_dim == 128)
    return launch<128>(is_bf16, q, k, v, out, lse, w, blocks, batch, heads,
                       kv_heads, t_q, t_k, causal, scale, window, s);
  if (head_dim == 64)
    return launch<64>(is_bf16, q, k, v, out, lse, w, blocks, batch, heads,
                      kv_heads, t_q, t_k, causal, scale, window, s);
  if (head_dim == 32)
    return launch<32>(is_bf16, q, k, v, out, lse, w, blocks, batch, heads,
                      kv_heads, t_q, t_k, causal, scale, window, s);
  if (head_dim == 16)
    return launch<16>(is_bf16, q, k, v, out, lse, w, blocks, batch, heads,
                      kv_heads, t_q, t_k, causal, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
