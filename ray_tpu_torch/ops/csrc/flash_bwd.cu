// Flash-attention backward for Hopper (sm_90a), behind a plain C interface:
// the FlashAttention-2 split into a dK/dV kernel and a dQ kernel.
//
// Replaces the TPU kernels of ray_tpu/ops/attention.py `_flash_backward`:
//   * dK/dV: pl.pallas_call at attention.py:280, kernel body
//     `_flash_bwd_dkv_kernel` at :158 (the column pass);
//   * dQ:    pl.pallas_call at attention.py:303, kernel body
//     `_flash_bwd_dq_kernel` at :210 (the row pass).
// Both recompute p = exp(s * sm_scale - lse) from the forward's per-row lse,
// with top-left causality (row >= col), so no score matrix ever reaches
// device memory.  A masked pair gets p = 0, which is what the TPU kernels'
// exp(-1e30 - lse) gives.  With delta = rowsum(dO * O)
// (computed in torch by the caller, as XLA does in the JAX package):
//   dV = p^T dO,  dS = p * (dO V^T - delta) * sm_scale,  dK = dS^T Q,
//   dQ = dS K.
// A query row with lse = +1e30 (it saw no column in the forward) gets p = 0.
//
// Layout: q, dO (bh, seq_q, d); k, v (bh_kv, seq_k, d); all contiguous, in
// float32 or bfloat16; lse, delta (bh, seq_q) f32; dq in q's type, dk and dv
// in k's type.  Grouped-query attention: query head bh reads KV head
// bh / (bh / bh_kv), as in flash_fwd.cu.  dK and dV of a KV head are the sums
// over the query heads of its group: the dK/dV block loops over those heads
// itself, so no atomics are needed and the result is the same from run to
// run.
//
// What bounds them on this card: per unmasked (query, key) pair the dK/dV
// pass does 8 * d operations (four products: q.k, dO.v, p dO, dS q) and the
// dQ pass 6 * d (q.k, dO.v, dS k); each moves about 8 * d bytes per row in
// bf16.  For the trainer's causal seq 1024 that is well above the H100's
// ~295 op/byte ridge, so the least time is set by the bf16 tensor cores.
//
// bf16 -> the tensor-core kernels, built from the forward's tile mechanics
// (flash_mma.cuh): blocks of 4 warps, each warp 16 rows of the block's
// 64-row tile; 64-row tiles streamed through a 2-stage cp.async ring with
// one commit group per iteration; products on mma.sync m16n8k16 with f32
// sums; scores scaled in f32 after the product, in the log2 domain of
// exp2f; P and dS rounded to bf16 in registers (pack_a) as the A operand
// of the next product; accumulators f32, rounded once on store; masks
// evaluated only on the causal-diagonal and seq_k-edge tiles.
//   * dQ, `flash_bwd_dq_mma_kernel`, query-stationary: one block per (bh,
//     64-row Q tile), heavy causal tiles first; Q and dO staged once and
//     read as A fragments; K/V tiles up to the diagonal in the ring; per
//     tile S = Q K^T and dP = dO V^T (K and V as plain-ldmatrix B
//     operands), p and dS with lse and delta per row in registers, then
//     dQ += dS K with K read by ldmatrix.trans.
//   * dK/dV, `flash_bwd_dkv_mma_kernel`, KV-stationary: one block per
//     (bh_kv, 64-row KV tile), KV tile 0 (which every causal Q tile sees)
//     first; K and V staged once and read as A fragments.  Q/dO tiles and
//     their lse and delta stream through the ring in one flat loop over the
//     group's query heads and, in each, the Q tiles from the first one the
//     causal mask lets see this KV tile, so the prefetch crosses from one
//     head to the next.  Per tile the transposed scores S^T = K Q^T and
//     dP^T = V dO^T come straight out of the products (Q and dO as
//     plain-ldmatrix B operands): each warp holds 16 keys x 64 queries, and
//     no score tile is ever transposed.  p^T and dS^T take lse and delta
//     per column (per query) from the ring's stats; then dV += P^T dO and
//     dK += dS^T Q with dO and Q read by ldmatrix.trans.  A Q row past
//     seq_q is zero-filled with lse = +1e30 and delta = 0, so its p and dS
//     are exactly 0; a key past seq_k is masked and never stored; a KV tile
//     that no query sees stores zeros.
// Registers: at D <= 64 the A fragments stay in registers for the whole
// sweep.  At D = 128 dQ re-reads Q and dO, and dK/dV K and V, from their
// shared-memory tiles for each product, and dK/dV takes the 64 queries of
// a tile in two halves of 32, so that its score fragments (32 registers)
// and its dK, dV accumulators (128) fit.
// Dynamic shared memory: dQ 30,720 / 55,296 / 104,448 bytes, dK/dV 31,744 /
// 56,320 / 105,472 bytes at D = 32 / 64 / 128.
//
// float32 -> the scalar f32 FMA kernels below, like flash_fwd.cu's float32
// kernel, which keep the float32 path within summation-order error of the
// plain version.  The dtype picks the kernel in the C entry points; neither
// kernel is a fallback for the other.  What the scalar design does:
//   * dK/dV: one block per (bh_kv, 64-row KV tile), 4 threads per KV row;
//     each thread keeps its quarter of the K and V rows and of the dK and dV
//     accumulators in registers for the whole sweep over the group's query
//     heads and the Q tiles from the first one the causal mask lets see
//     this KV tile.  Q and dO are staged in shared memory 32 rows at a time,
//     with their lse and delta, and read back as float4 broadcasts.
//   * dQ: one block per (bh, 64-row Q tile), 4 threads per query row, Q, dO
//     and the dQ accumulator in registers; K and V are staged 32 rows at a
//     time, up to the diagonal tile, as the forward does.
//   * both dot products of a pair (q.k and dO.v) are summed with two xor
//     shuffles among the 4 adjacent lanes of one row only;
//   * staged rows past seq are zero-filled and masked or out-of-range pairs
//     get p = 0 exactly, so they contribute exactly 0 (no garbage * 0 = NaN).
// Their static shared memory stays under 33 KB for d <= 128.  wgmma, TMA
// staging and warp specialisation are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "flash_mma.cuh"

namespace {

constexpr int kThreadsPerRow = 4;  // lanes that share one row
constexpr int kRowsPerBlock = 64;  // KV rows (dK/dV) or Q rows (dQ) per block
constexpr int kThreads = kRowsPerBlock * kThreadsPerRow;
constexpr int kStageRows = 32;     // rows staged in shared memory per tile

// Sum over the 4 adjacent lanes of one row (xor 1, 2 stay inside the group).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Thread `part` of a row owns dims c * 16 + part * 4 + e (c < D / 16, e < 4),
// as in flash_fwd.cu: the 4 lanes of a row read 64 contiguous bytes.
template <int D>
__device__ __forceinline__ float dot_row(const float (&reg)[D / 4],
                                         const float* row, int part) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(&row[c * 16 + part * 4]);
    dot = fmaf(reg[c * 4 + 0], x.x, dot);
    dot = fmaf(reg[c * 4 + 1], x.y, dot);
    dot = fmaf(reg[c * 4 + 2], x.z, dot);
    dot = fmaf(reg[c * 4 + 3], x.w, dot);
  }
  return dot;
}

// acc += a * row (this thread's dims of a staged row)
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D / 4], float a,
                                         const float* row, int part) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(&row[c * 16 + part * 4]);
    acc[c * 4 + 0] = fmaf(a, x.x, acc[c * 4 + 0]);
    acc[c * 4 + 1] = fmaf(a, x.y, acc[c * 4 + 1]);
    acc[c * 4 + 2] = fmaf(a, x.z, acc[c * 4 + 2]);
    acc[c * 4 + 3] = fmaf(a, x.w, acc[c * 4 + 3]);
  }
}

// This thread's dims of global row `row` of `base` (zeros when !ok).
template <int D>
__device__ __forceinline__ void load_row(float (&reg)[D / 4],
                                         const float* base, bool ok,
                                         int part) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      reg[c * 4 + e] = ok ? base[c * 16 + part * 4 + e] : 0.f;
    }
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* base,
                                          const float (&reg)[D / 4],
                                          int part) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) base[c * 16 + part * 4 + e] = reg[c * 4 + e];
  }
}

// Stage rows [r0, r0 + kStageRows) of two (rows, D) arrays into shared
// memory, zero-filling rows at or past n_rows.
template <int D>
__device__ __forceinline__ void stage_tiles(float (*a_tile)[D],
                                            float (*b_tile)[D], const float* a,
                                            const float* b, int r0,
                                            int n_rows, int tid) {
  for (int idx = tid; idx < kStageRows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const bool ok = r0 + r < n_rows;
    a_tile[r][c] = ok ? a[(size_t)(r0 + r) * D + c] : 0.f;
    b_tile[r][c] = ok ? b[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// float32 only: bf16 takes flash_bwd_dkv_mma_kernel.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ d_out,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int group, int seq_q, int seq_k,
                     float sm_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(2 * kStageRows * D * sizeof(float) <= 48 * 1024,
                "static shared memory is capped at 48 KB");
  __shared__ __align__(16) float q_tile[kStageRows][D];
  __shared__ __align__(16) float do_tile[kStageRows][D];
  __shared__ float lse_tile[kStageRows];
  __shared__ float delta_tile[kStageRows];

  const int kv_bh = blockIdx.y;
  const int kv0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int col = kv0 + tid / kThreadsPerRow;  // this thread's KV row
  const bool col_ok = col < seq_k;

  float kr[D / 4], vr[D / 4], dk_acc[D / 4], dv_acc[D / 4];
  const size_t kv_off = ((size_t)kv_bh * seq_k + (col_ok ? col : 0)) * D;
  load_row<D>(kr, k + kv_off, col_ok, part);
  load_row<D>(vr, v + kv_off, col_ok, part);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int n_tiles = (seq_q + kStageRows - 1) / kStageRows;
  // causal: query rows before this KV tile's first row never see it
  const int first_tile = kCausal ? kv0 / kStageRows : 0;

  for (int g = 0; g < group; ++g) {
    const int bh = kv_bh * group + g;
    const float* q_base = q + (size_t)bh * seq_q * D;
    const float* do_base = d_out + (size_t)bh * seq_q * D;
    for (int t = first_tile; t < n_tiles; ++t) {
      const int q0 = t * kStageRows;
      __syncthreads();  // every thread is done with the previous tile
      stage_tiles<D>(q_tile, do_tile, q_base, do_base, q0, seq_q, tid);
      if (tid < kStageRows) {
        const bool ok = q0 + tid < seq_q;
        const size_t r = (size_t)bh * seq_q + q0 + tid;
        lse_tile[tid] = ok ? lse[r] : 0.f;
        delta_tile[tid] = ok ? delta[r] : 0.f;
      }
      __syncthreads();

      for (int i = 0; i < kStageRows; ++i) {
        const int row = q0 + i;
        const float s = row_sum(dot_row<D>(kr, q_tile[i], part)) * sm_scale;
        const bool masked =
            row >= seq_q || !col_ok || (kCausal && row < col);
        const float p = masked ? 0.f : expf(s - lse_tile[i]);
        axpy_row<D>(dv_acc, p, do_tile[i], part);
        const float dp = row_sum(dot_row<D>(vr, do_tile[i], part));
        const float ds = p * (dp - delta_tile[i]) * sm_scale;
        axpy_row<D>(dk_acc, ds, q_tile[i], part);
      }
    }
  }

  if (!col_ok) return;
  store_row<D>(dk + kv_off, dk_acc, part);
  store_row<D>(dv + kv_off, dv_acc, part);
}

// float32 only: bf16 takes flash_bwd_dq_mma_kernel.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ d_out,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int group, int seq_q, int seq_k, float sm_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(2 * kStageRows * D * sizeof(float) <= 48 * 1024,
                "static shared memory is capped at 48 KB");
  __shared__ __align__(16) float k_tile[kStageRows][D];
  __shared__ __align__(16) float v_tile[kStageRows][D];

  const int bh = blockIdx.y;
  const int kv_bh = bh / group;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = q0 + tid / kThreadsPerRow;  // this thread's query row
  const bool row_ok = row < seq_q;

  float qr[D / 4], dor[D / 4], dq_acc[D / 4];
  const size_t q_off = ((size_t)bh * seq_q + (row_ok ? row : 0)) * D;
  load_row<D>(qr, q + q_off, row_ok, part);
  load_row<D>(dor, d_out + q_off, row_ok, part);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq_acc[i] = 0.f;
  const float row_lse = row_ok ? lse[(size_t)bh * seq_q + row] : 0.f;
  const float row_delta = row_ok ? delta[(size_t)bh * seq_q + row] : 0.f;

  const float* k_base = k + (size_t)kv_bh * seq_k * D;
  const float* v_base = v + (size_t)kv_bh * seq_k * D;
  int n_tiles = (seq_k + kStageRows - 1) / kStageRows;
  if (kCausal) {
    // only tiles at or before this block's last query row take part
    n_tiles = min(n_tiles, (q0 + kRowsPerBlock + kStageRows - 1) / kStageRows);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kStageRows;
    __syncthreads();  // every thread is done with the previous tile
    stage_tiles<D>(k_tile, v_tile, k_base, v_base, kv0, seq_k, tid);
    __syncthreads();

    for (int j = 0; j < kStageRows; ++j) {
      const int col = kv0 + j;
      const float s = row_sum(dot_row<D>(qr, k_tile[j], part)) * sm_scale;
      const bool masked = !row_ok || col >= seq_k || (kCausal && col > row);
      const float p = masked ? 0.f : expf(s - row_lse);
      const float dp = row_sum(dot_row<D>(dor, v_tile[j], part));
      const float ds = p * (dp - row_delta) * sm_scale;
      axpy_row<D>(dq_acc, ds, k_tile[j], part);
    }
  }

  if (!row_ok) return;
  store_row<D>(dq + q_off, dq_acc, part);
}

// Shared memory of the bf16 dQ kernel: the Q and dO tiles, then a 2-stage
// ring of (K tile, V tile); 30,720 / 55,296 / 104,448 bytes at D = 32 / 64 /
// 128.
template <int D>
constexpr int dq_mma_smem_bytes() {
  return 6 * rtt_mma::Tile<D>::kBytes;
}

// bf16 dQ on the tensor cores (see the note at the top and flash_mma.cuh).
// Q and dO stay in A fragments for the whole sweep at D <= 64; at D = 128
// they would take 64 of the ~190 registers a thread needs, so there they
// are read from their shared-memory tiles for each product instead.
template <int D, bool kCausal>
__global__ void __launch_bounds__(rtt_mma::kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ d_out,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int group, int seq_q,
                        int seq_k, float sm_scale) {
  using namespace rtt_mma;
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr bool kFragsInRegs = D <= 64;
  constexpr int kSlabs = kFragsInRegs ? D / 16 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + Tile<D>::kElems;
  bf16* ring = do_s + Tile<D>::kElems;  // stage s: K at 2s, V at 2s + 1

  const int bh = blockIdx.x;
  const int kv_bh = bh / group;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = q_tile * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // this lane's rows: a, a+8
  const float scale_log2 = sm_scale * kLog2e;

  const bf16* k_base = k + (size_t)kv_bh * seq_k * D;
  const bf16* v_base = v + (size_t)kv_bh * seq_k * D;
  int n_tiles = (seq_k + kRows - 1) / kRows;
  if (kCausal) n_tiles = min(n_tiles, q_tile + 1);

  load_tile<D>(q_s, q + (size_t)bh * seq_q * D, q0, seq_q, tid);
  load_tile<D>(do_s, d_out + (size_t)bh * seq_q * D, q0, seq_q, tid);
  if (n_tiles > 0) {
    load_tile<D>(ring, k_base, 0, seq_k, tid);
    load_tile<D>(ring + Tile<D>::kElems, v_base, 0, seq_k, tid);
  }
  cp_async_commit();

  // per-row lse (log2 domain) and delta; a row past seq_q gets lse = +1e30,
  // so its p is exactly 0, as is that of a row that saw no column
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const bool ok = row < seq_q;
    lse2[i] = (ok ? lse[(size_t)bh * seq_q + row] : -kNegInf) * kLog2e;
    dlt[i] = ok ? delta[(size_t)bh * seq_q + row] : 0.f;
  }

  uint32_t qf[kSlabs][4], dof[kSlabs][4];  // A fragments kept (D <= 64)
  float acc[D / 8][4];                     // dQ, f32, rows a and a + 8
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  const uint32_t q_u = smem_u32(q_s), do_u = smem_u32(do_s);

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // prefetch tile j + 1 into the other stage
      bf16* st = ring + 2 * ((j + 1) & 1) * Tile<D>::kElems;
      load_tile<D>(st, k_base, (j + 1) * kRows, seq_k, tid);
      load_tile<D>(st + Tile<D>::kElems, v_base, (j + 1) * kRows, seq_k, tid);
    }
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile j (and Q, dO) landed for this thread...
    __syncthreads();     // ...and for every thread
    if (kFragsInRegs && j == 0) {  // Q and dO landed with tile 0
#pragma unroll
      for (int kk = 0; kk < kSlabs; ++kk) {
        load_a<D>(qf[kk], q_u, warp * 16, kk * 16, lane);
        load_a<D>(dof[kk], do_u, warp * 16, kk * 16, lane);
      }
    }
    const uint32_t k_s = smem_u32(ring + 2 * (j & 1) * Tile<D>::kElems);
    const uint32_t v_s = k_s + Tile<D>::kBytes;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp each
    float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (kFragsInRegs) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qa[r] = qf[kk][r];
          da[r] = dof[kk][r];
        }
      } else {
        load_a<D>(qa, q_u, warp * 16, kk * 16, lane);
        load_a<D>(da, do_u, warp * 16, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t b[4];
        load_b_keys<D>(b, k_s, np * 16, kk * 16, lane);
        mma(s[2 * np], qa, b[0], b[1]);
        mma(s[2 * np + 1], qa, b[2], b[3]);
        load_b_keys<D>(b, v_s, np * 16, kk * 16, lane);
        mma(dp[2 * np], da, b[0], b[1]);
        mma(dp[2 * np + 1], da, b[2], b[3]);
      }
    }

    // p = exp(S * scale - lse), exactly 0 where masked; then
    // dS = p * (dP - delta) * scale in f32, kept in s
    const int kv0 = j * kRows;
    const bool edge = kv0 + kRows > seq_k || (kCausal && kv0 + kRows - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]);
        if (edge && masked<kCausal>(kv0, nt, e, t, row_a, seq_k)) p = 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[e >> 1]) * sm_scale;
      }
    }

    // dQ += dS K, dS rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        load_b_dims<D>(b, k_s, kk * 16, np * 16, lane);
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1 before refill
  }

  cp_async_wait<0>();  // no copy outlives the block (seq_k == 0)
  store_rows<D>(dq + (size_t)bh * seq_q * D, acc, row_a, seq_q, t, 1.f, 1.f);
}

// Shared memory of the bf16 dK/dV kernel: the K and V tiles, a 2-stage
// ring of (Q tile, dO tile), then per stage the tile's 64 lse and 64 delta
// values; 31,744 / 56,320 / 105,472 bytes at D = 32 / 64 / 128.
template <int D>
constexpr int dkv_mma_smem_bytes() {
  return 6 * rtt_mma::Tile<D>::kBytes +
         2 * 2 * rtt_mma::kRows * (int)sizeof(float);
}

// Start the copies of Q tile `q_tile` of query head `bh`, its dO tile, and
// their lse and delta into ring stage `stage` of the dK/dV kernel.  lse and
// delta go by 4-byte copies, threads 0-63 lse and 64-127 delta, one row
// each; a row past seq_q gets lse = +1e30 and delta = 0 instead, so its p
// and dS are exactly 0 (its Q and dO rows are zero-filled).
template <int D>
__device__ __forceinline__ void load_q_stage(
    rtt_mma::bf16* ring, float* stats, int stage,
    const rtt_mma::bf16* q, const rtt_mma::bf16* d_out, const float* lse,
    const float* delta, int bh, int q_tile, int seq_q, int tid) {
  using namespace rtt_mma;
  static_assert(rtt_mma::kThreads == 2 * kRows,
                "one lse or delta row per thread");
  const size_t head = (size_t)bh * seq_q;
  const int q0 = q_tile * kRows;
  bf16* q_s = ring + 2 * stage * Tile<D>::kElems;
  load_tile<D>(q_s, q + head * D, q0, seq_q, tid);
  load_tile<D>(q_s + Tile<D>::kElems, d_out + head * D, q0, seq_q, tid);
  const bool is_lse = tid < kRows;
  const int row = q0 + tid % kRows;
  float* dst = stats + stage * 2 * kRows + tid;  // lse, then delta
  if (row < seq_q) {
    cp_async_4(smem_u32(dst), (is_lse ? lse : delta) + head + row);
  } else {
    *dst = is_lse ? -kNegInf : 0.f;
  }
}

// bf16 dK/dV on the tensor cores (see the note at the top and
// flash_mma.cuh).  Each warp owns 16 keys of the block's KV tile; the
// transposed scores of a Q tile are 16 keys x kCols queries per warp,
// taken kRows / kCols times per tile.
template <int D, bool kCausal>
__global__ void __launch_bounds__(rtt_mma::kThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ d_out,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int group, int seq_q,
                         int seq_k, float sm_scale) {
  using namespace rtt_mma;
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr bool kFragsInRegs = D <= 64;
  constexpr int kSlabs = kFragsInRegs ? D / 16 : 1;
  constexpr int kCols = kFragsInRegs ? kRows : kRows / 2;  // queries at once
  constexpr int kColTiles = kCols / 8;  // n8 tiles of transposed scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + Tile<D>::kElems;
  bf16* ring = v_s + Tile<D>::kElems;  // stage s: Q at 2s, dO at 2s + 1
  float* stats = reinterpret_cast<float*>(ring + 4 * Tile<D>::kElems);

  const int kv_bh = blockIdx.x;
  const int kv_tile = blockIdx.y;  // tile 0, which every Q tile sees, first
  const int kv0 = kv_tile * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int key_a = kv0 + warp * 16 + (lane >> 2);  // this lane's keys: a, a+8
  const float scale_log2 = sm_scale * kLog2e;

  // one flat sweep over the group's query heads and, in each, the Q tiles
  // from the first one the causal mask lets see this KV tile
  const int n_q_tiles = (seq_q + kRows - 1) / kRows;
  const int first = kCausal ? min(kv_tile, n_q_tiles) : 0;
  const int per_head = n_q_tiles - first;
  const int n_iter = group * per_head;
  const int bh0 = kv_bh * group;

  load_tile<D>(k_s, k + (size_t)kv_bh * seq_k * D, kv0, seq_k, tid);
  load_tile<D>(v_s, v + (size_t)kv_bh * seq_k * D, kv0, seq_k, tid);
  if (n_iter > 0) {
    load_q_stage<D>(ring, stats, 0, q, d_out, lse, delta, bh0, first, seq_q,
                    tid);
  }
  cp_async_commit();

  uint32_t kf[kSlabs][4], vf[kSlabs][4];  // A fragments kept (D <= 64)
  float dk_acc[D / 8][4], dv_acc[D / 8][4];  // f32, keys a and a + 8
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  }
  const uint32_t k_u = smem_u32(k_s), v_u = smem_u32(v_s);
  const bool kv_edge = kv0 + kRows > seq_k;

  for (int i = 0; i < n_iter; ++i) {
    if (i + 1 < n_iter) {  // prefetch step i + 1, maybe of the next head
      load_q_stage<D>(ring, stats, (i + 1) & 1, q, d_out, lse, delta,
                      bh0 + (i + 1) / per_head, first + (i + 1) % per_head,
                      seq_q, tid);
    }
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // step i (and K, V) landed for this thread...
    __syncthreads();     // ...and for every thread
    if (kFragsInRegs && i == 0) {  // K and V landed with step 0
#pragma unroll
      for (int kk = 0; kk < kSlabs; ++kk) {
        load_a<D>(kf[kk], k_u, warp * 16, kk * 16, lane);
        load_a<D>(vf[kk], v_u, warp * 16, kk * 16, lane);
      }
    }
    const uint32_t q_u = smem_u32(ring + 2 * (i & 1) * Tile<D>::kElems);
    const uint32_t do_u = q_u + Tile<D>::kBytes;
    const float* lse_s = stats + (i & 1) * 2 * kRows;
    const float* dlt_s = lse_s + kRows;
    const int q0 = (first + i % per_head) * kRows;
    const bool edge = kv_edge || (kCausal && q0 < kv0 + kRows - 1);

#pragma unroll
    for (int c0 = 0; c0 < kRows; c0 += kCols) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kCols queries per warp
      float s[kColTiles][4], dp[kColTiles][4];
#pragma unroll
      for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (kFragsInRegs) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ka[r] = kf[kk][r];
            va[r] = vf[kk][r];
          }
        } else {
          load_a<D>(ka, k_u, warp * 16, kk * 16, lane);
          load_a<D>(va, v_u, warp * 16, kk * 16, lane);
        }
#pragma unroll
        for (int np = 0; np < kColTiles / 2; ++np) {
          uint32_t b[4];
          load_b_keys<D>(b, q_u, c0 + np * 16, kk * 16, lane);
          mma(s[2 * np], ka, b[0], b[1]);
          mma(s[2 * np + 1], ka, b[2], b[3]);
          load_b_keys<D>(b, do_u, c0 + np * 16, kk * 16, lane);
          mma(dp[2 * np], va, b[0], b[1]);
          mma(dp[2 * np + 1], va, b[2], b[3]);
        }
      }

      // p^T = exp(S^T * scale - lse[col]), exactly 0 where masked, kept in
      // s; dS^T = p^T * (dP^T - delta[col]) * scale, kept in dp; lse and
      // delta of this lane's columns 2t, 2t + 1 of each n8 tile
#pragma unroll
      for (int nt = 0; nt < kColTiles; ++nt) {
        const int c = c0 + nt * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(&lse_s[c]);
        const float2 d = *reinterpret_cast<const float2*>(&dlt_s[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = ((e & 1) ? l.y : l.x) * kLog2e;
          float p = exp2f(s[nt][e] * scale_log2 - lse2);
          if (edge && masked_t<kCausal>(q0 + c0, nt, e, t, key_a, seq_k)) {
            p = 0.f;
          }
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? d.y : d.x)) * sm_scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
      // registers, dO and Q read by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kColTiles / 2; ++kk) {
        uint32_t pa[4], da[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          load_b_dims<D>(b, do_u, c0 + kk * 16, np * 16, lane);
          mma(dv_acc[2 * np], pa, b[0], b[1]);
          mma(dv_acc[2 * np + 1], pa, b[2], b[3]);
          load_b_dims<D>(b, q_u, c0 + kk * 16, np * 16, lane);
          mma(dk_acc[2 * np], da, b[0], b[1]);
          mma(dk_acc[2 * np + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage i & 1 before refill
  }

  cp_async_wait<0>();  // no copy outlives the block (no Q tile to sweep)
  const size_t kv_base = (size_t)kv_bh * seq_k * D;
  store_rows<D>(dk + kv_base, dk_acc, key_a, seq_k, t, 1.f, 1.f);
  store_rows<D>(dv + kv_base, dv_acc, key_a, seq_k, t, 1.f, 1.f);
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* d_out, const float* lse,
                          const float* delta, void* dq, int bh, int group,
                          int seq_q, int seq_k, bool causal, float sm_scale,
                          cudaStream_t stream) {
  const int tiles = (seq_q + rtt_mma::kRows - 1) / rtt_mma::kRows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(bh, tiles);
  constexpr int smem = dq_mma_smem_bytes<D>();
  auto kernel = causal ? flash_bwd_dq_mma_kernel<D, true>
                       : flash_bwd_dq_mma_kernel<D, false>;
  const cudaError_t rc = rtt_mma::allow_smem(kernel, smem);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, rtt_mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(d_out), lse, delta,
      static_cast<__nv_bfloat16*>(dq), group, seq_q, seq_k, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* d_out, const float* lse,
                           const float* delta, void* dk, void* dv, int bh_kv,
                           int group, int seq_q, int seq_k, bool causal,
                           float sm_scale, cudaStream_t stream) {
  const int tiles = (seq_k + rtt_mma::kRows - 1) / rtt_mma::kRows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(bh_kv, tiles);
  constexpr int smem = dkv_mma_smem_bytes<D>();
  auto kernel = causal ? flash_bwd_dkv_mma_kernel<D, true>
                       : flash_bwd_dkv_mma_kernel<D, false>;
  const cudaError_t rc = rtt_mma::allow_smem(kernel, smem);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, rtt_mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(d_out), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), group,
      seq_q, seq_k, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* d_out, const float* lse,
                       const float* delta, void* dk, void* dv, int bh_kv,
                       int group, int seq_q, int seq_k, bool causal,
                       float sm_scale, cudaStream_t stream) {
  const dim3 grid((seq_k + kRowsPerBlock - 1) / kRowsPerBlock, bh_kv);
  auto kernel = causal ? flash_bwd_dkv_kernel<D, true>
                       : flash_bwd_dkv_kernel<D, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_out), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), group, seq_q,
      seq_k, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* d_out, const float* lse, const float* delta,
                      void* dq, int bh, int group, int seq_q, int seq_k,
                      bool causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid((seq_q + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  auto kernel = causal ? flash_bwd_dq_kernel<D, true>
                       : flash_bwd_dq_kernel<D, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_out), lse,
      delta, static_cast<float*>(dq), group, seq_q, seq_k, sm_scale);
  return cudaGetLastError();
}

// Shape checks shared by both entry points: 0 when the launch may go ahead.
// `grid_rows` is the length the kernel's grid walks; an empty grid is not a
// launch.
int check_shape(int bh, int bh_kv, int seq_q, int seq_k, int grid_rows) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || bh > 65535 || seq_q < 0 ||
      seq_k < 0 || grid_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

// Returns F32<D>(...) for float32 (dtype 0) and BF16<D>(...) for bfloat16
// (dtype 1) at the runtime head_dim, or cudaErrorInvalidValue for a dtype
// or head_dim the kernels do not take.
#define RTT_LAUNCH(F32, BF16, dtype, head_dim, ...)                \
  do {                                                             \
    if ((dtype) == 0) {                                            \
      switch (head_dim) {                                          \
        case 32: return (int)F32<32>(__VA_ARGS__);                 \
        case 64: return (int)F32<64>(__VA_ARGS__);                 \
        case 128: return (int)F32<128>(__VA_ARGS__);               \
      }                                                            \
    } else if ((dtype) == 1) {                                     \
      switch (head_dim) {                                          \
        case 32: return (int)BF16<32>(__VA_ARGS__);                \
        case 64: return (int)BF16<64>(__VA_ARGS__);                \
        case 128: return (int)BF16<128>(__VA_ARGS__);              \
      }                                                            \
    }                                                              \
    return (int)cudaErrorInvalidValue;                             \
  } while (0)

}  // namespace

// dtype: 0 = float32 (the scalar kernels), 1 = bfloat16 (the tensor-core
// kernels).  Each returns the cudaError_t of its launch (0 on success); the
// caller raises on anything else.  The dK/dV kernels need seq_k > 0 and the
// dQ kernels seq_q > 0; each writes every element of its outputs.

extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* d_out, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int bh_kv, int seq_q, int seq_k,
                                 int head_dim, int causal, float sm_scale,
                                 int dtype, void* stream) {
  const int rc = check_shape(bh, bh_kv, seq_q, seq_k, seq_k);
  if (rc != 0) return rc;
  RTT_LAUNCH(launch_dkv, launch_dkv_mma, dtype, head_dim, q, k, v, d_out,
             static_cast<const float*>(lse), static_cast<const float*>(delta),
             dk, dv, bh_kv, bh / bh_kv, seq_q, seq_k, causal != 0, sm_scale,
             static_cast<cudaStream_t>(stream));
}

extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* d_out, const void* lse,
                                const void* delta, void* dq, int bh,
                                int bh_kv, int seq_q, int seq_k, int head_dim,
                                int causal, float sm_scale, int dtype,
                                void* stream) {
  const int rc = check_shape(bh, bh_kv, seq_q, seq_k, seq_q);
  if (rc != 0) return rc;
  RTT_LAUNCH(launch_dq, launch_dq_mma, dtype, head_dim, q, k, v, d_out,
             static_cast<const float*>(lse), static_cast<const float*>(delta),
             dq, bh, bh / bh_kv, seq_q, seq_k, causal != 0, sm_scale,
             static_cast<cudaStream_t>(stream));
}
