// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubeshare_tpu/ops/attention.py
// _flash_kernel (launched by _flash_forward): causal / sliding-window /
// grouped-query attention with an online softmax, returning the output
// and the row log-sum-exp. Its plain PyTorch version is
// flash_attention_reference in ../attention.py.
//
// Layout. q [B*H, Tq, D], k/v [B*Hkv, Tk, D], out like q, lse [B*H, Tq]
// float32, all contiguous and 16-byte aligned. One thread block per
// (b*h, 64-row q tile); a loop over 64-key K/V tiles inside the block
// replaces the Pallas grid's sequential third axis. The kv head is
// picked from blockIdx as (b / H) * Hkv + (b % H) / (H / Hkv), so K/V
// are never repeated. The loop bounds come from the causal diagonal and
// the window: tiles that no query of the block can see are never
// loaded (the TPU kernel skipped their compute but still ran their
// DMA). Ragged edges are masked here: rows past Tq are computed on
// zeros and not written, keys past Tk are zero-filled and masked.
//
// Numerics kept from _flash_kernel: products of input-dtype values
// accumulated in float32; float32 running max, sum and accumulator;
// -1e30 (not -inf) for masked scores; P rounded to the input dtype
// before the PV product (its row sum taken before the rounding);
// l = max(l, 1e-30); lse = m + log(l). Causal rows align to the end of
// the keys (query i is at position i + Tk - Tq; the wrapper requires
// Tq <= Tk).
//
// What bounds it on the H100. At the Llama-3-8B smoke shape (B=1,
// H=32, Hkv=8, T=2048, D=128, causal, bf16) the work is ~34.4 GFLOP
// against ~42 MB of traffic: ~35 us at 989 TFLOP/s of bf16 tensor-core
// peak, ~13 us at 3.35 TB/s. It is compute-bound, so the bf16 kernel
// (flash_fwd_bf16) runs both products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, float32 accumulators): 4 warps of 16
// query rows each; Q's fragments stay in registers for the whole key
// loop; K/V tiles are staged in padded shared memory and fed with
// ldmatrix (.trans for V); the S accumulators are re-packed in
// registers as the A operand of the PV product (no trip through shared
// memory); the next K/V tile is fetched with cp.async into a second
// buffer while the current one computes. By instruction count the
// softmax, not the tensor cores, bounds the tile loop, so tiles that
// every row sees whole skip the per-element mask and the exponentials
// run as ex2.approx on the special-function unit. TMA, a deeper ring, warp
// specialisation and wgmma are the next steps (ROADMAP Queue 2).
// float32 inputs have no tensor-core path with float32 products, so
// flash_fwd_f32 does them with FMAs on the CUDA cores (67 TFLOP/s peak).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile (FLASH_BLOCK_K in attention.py)
constexpr float NEG_INF = -1e30f;

// Keys [lo, hi) that any real query of the tile at q0 can see, and the
// absolute position of the tile's first query.
struct KeyRange {
  int lo, hi, q_first;
};

__device__ __forceinline__ KeyRange key_range(int q0, int t_q, int t_k,
                                              int causal, int window) {
  const int offset = causal ? t_k - t_q : 0;
  KeyRange r{0, t_k, q0 + offset};
  if (causal) {
    r.hi = min(t_k, min(q0 + BQ, t_q) - 1 + offset + 1);
    if (window > 0) r.lo = max(0, r.q_first - window + 1);
  }
  r.lo -= r.lo % BK;  // tiles are aligned to BK
  return r;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int t_k,
                                        int causal, int window) {
  bool vis = kpos < t_k;
  if (causal) {
    vis = vis && kpos <= qpos;
    if (window > 0) vis = vis && kpos > qpos - window;
  }
  return vis;
}

// ---- bf16: tensor cores (mma.sync) ----------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^x as 2^(x log2 e) on the special-function unit (relative error at
// most 2^-22). x is a difference of two scores: exactly 0 when both are
// the -1e30 mask, which gives 1 as expf does, and about -1.4e30 for a
// masked score against a real maximum, which gives 0.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in low bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying rows [row0, row0 + 64) of a [rows, D] bf16 matrix into
// shared memory with leading dim D + 8 (16 extra bytes per row: the
// eight row reads of an ldmatrix then fall in distinct banks), 16 bytes
// per cp.async; rows past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n_rows) {
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < 64 * VEC; idx += MMA_THREADS) {
    const int r = idx / VEC, c = idx % VEC;
    const bool in = row0 + r < n_rows;
    // a zero-filled copy reads nothing, but its address stays in bounds
    const __nv_bfloat16* from = src + (size_t)(in ? row0 + r : 0) * D + c * 8;
    const uint32_t to = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + r * (D + 8) + c * 8));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int heads, int kv_heads, int t_q, int t_k, int causal,
                   float scale, int window) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;  // k-steps of the QK^T product
  constexpr int DT = D / 8;   // 8-wide output column tiles
  constexpr int NT = BK / 8;  // 8-wide score column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q tile, then two K and two V tiles: tile i+1 loads while i computes
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + 2 * BK * LD;

  const int bh = blockIdx.y;
  // the last q tiles see the most keys under a causal mask: start them
  // first, so the short ones fill the tail of the grid
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / (heads / kv_heads);
  const __nv_bfloat16* kp = k + (size_t)kvh * t_k * D;
  const __nv_bfloat16* vp = v + (size_t)kvh * t_k * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix matrix / row
  const KeyRange range = key_range(q0, t_q, t_k, causal, window);

  load_tile_async<D>(qs, q + (size_t)bh * t_q * D, q0, t_q);
  cp_async_commit();
  load_tile_async<D>(ks, kp, range.lo, t_k);
  load_tile_async<D>(vs, vp, range.lo, t_k);
  cp_async_commit();
  cp_async_wait<1>();  // q has landed
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 rows of Q as A fragments
#pragma unroll
  for (int s = 0; s < KS; ++s)
    ldmatrix_x4(qf[s], qs + (warp * 16 + lane % 16) * LD + s * 16 +
                           (lane / 16) * 8);

  // absolute positions of this thread's two rows (g and g + 8)
  const int qpos0 = range.q_first + warp * 16 + g, qpos1 = qpos0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  for (int k0 = range.lo, buf = 0; k0 < range.hi; k0 += BK, buf ^= 1) {
    if (k0 + BK < range.hi) {  // prefetch the next tile into the other buffer
      load_tile_async<D>(ks + (buf ^ 1) * BK * LD, kp, k0 + BK, t_k);
      load_tile_async<D>(vs + (buf ^ 1) * BK * LD, vp, k0 + BK, t_k);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * BK * LD;
    const __nv_bfloat16* vt = vs + buf * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        // keys 8t..8t+15 (rows of K), dims 16st..16st+15
        uint32_t b[4];
        ldmatrix_x4(b, kt + (t * 8 + mr + 8 * (mi >> 1)) * LD + st * 16 +
                           8 * (mi & 1));
        mma_bf16(s[t], qf[st], b[0], b[1]);
        mma_bf16(s[t + 1], qf[st], b[2], b[3]);
      }
    }

#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] *= scale;
    // the per-element mask only where some (row, key) pair of the tile
    // is not visible: the diagonal, the window's edge, the ragged end
    const bool whole =
        k0 + BK <= t_k &&
        (!causal || (k0 + BK - 1 <= range.q_first &&
                     (window <= 0 || k0 > range.q_first + BQ - 1 - window)));
    if (!whole) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + t * 8 + 2 * tig + e;
          if (!visible(qpos0, kpos, t_k, causal, window)) s[t][e] = NEG_INF;
          if (!visible(qpos1, kpos, t_k, causal, window))
            s[t][2 + e] = NEG_INF;
        }
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
    // a row's 64 scores sit in the 4 lanes of a quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float c0 = fast_exp(m0 - n0), c1 = fast_exp(m1 - n1);
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pf[NT / 2][4];  // P as A fragments of the PV product
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float p0 = fast_exp(s[t][0] - n0), p1 = fast_exp(s[t][1] - n0);
      const float p2 = fast_exp(s[t][2] - n1), p3 = fast_exp(s[t][3] - n1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pf[t / 2][(t % 2) * 2] = pack_bf16(p0, p1);      // row g
      pf[t / 2][(t % 2) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      o[t][0] *= c0;
      o[t][1] *= c0;
      o[t][2] *= c1;
      o[t][3] *= c1;
    }

#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        // keys 16j..16j+15 (rows of V), dims 8t..8t+15, transposed
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (j * 16 + mr + 8 * (mi & 1)) * LD + t * 8 +
                                 8 * (mi >> 1));
        mma_bf16(o[t], pf[j], b[0], b[1]);
        mma_bf16(o[t + 1], pf[j], b[2], b[3]);
      }
    }
    __syncthreads();  // done reading buf before the next prefetch refills it
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  __nv_bfloat16* op = out + (size_t)bh * t_q * D;
  if (row0 < t_q) {
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row0 * D + t * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(o[t][0] * inv0, o[t][1] * inv0);
    if (tig == 0) lse[(size_t)bh * t_q + row0] = m0 + logf(fmaxf(l0, 1e-30f));
  }
  if (row1 < t_q) {
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row1 * D + t * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(o[t][2] * inv1, o[t][3] * inv1);
    if (tig == 0) lse[(size_t)bh * t_q + row1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

// ---- float32: CUDA-core FMAs -----------------------------------------

constexpr int FMA_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int LDQ = BQ + 1;       // padded leading dims: conflict-free stores
constexpr int LDK = BK + 1;

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

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           void* out, void* lse, int batch, int heads, int kv_heads, int t_q,
           int t_k, int causal, float scale, int window,
           cudaStream_t stream) {
  const dim3 grid((t_q + BQ - 1) / BQ, batch * heads);
  // above 48 KB a block's shared memory must be opted into (per device,
  // so on every launch: the call is cheap)
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const size_t smem = (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(T);
    err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16<D><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), heads, kv_heads, t_q, t_k, causal, scale,
        window);
  } else {
    const size_t smem = f32_smem_floats<D>() * sizeof(float);
    err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
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
// alignment.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int batch, int heads,
                         int kv_heads, int t_q, int t_k, int head_dim,
                         int is_bf16, int causal, float scale, int window,
                         void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads ||
      t_q <= 0 || t_k <= 0 || batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch<128>(is_bf16, q, k, v, out, lse, batch, heads, kv_heads,
                       t_q, t_k, causal, scale, window, s);
  if (head_dim == 64)
    return launch<64>(is_bf16, q, k, v, out, lse, batch, heads, kv_heads,
                      t_q, t_k, causal, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
