// Flash-attention forward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py `_flash_forward`
// (pl.pallas_call at attention.py:121, kernel body `_flash_kernel` at :49).
// It computes the same function: out = softmax(q * sm_scale @ k^T) @ v with
// an online softmax, masked entries set to -1e30, top-left causality
// (row >= col), and the per-row lse = m + log(l); a row that saw no column
// gets out = 0 and lse = +1e30.
//
// Layout: q (bh, seq_q, d), k and v (bh_kv, seq_k, d), all contiguous, in
// float32 or bfloat16; out (bh, seq_q, d) in q's type; lse (bh, seq_q) f32.
// Grouped-query attention reads KV row bh / (bh / bh_kv) directly instead of
// materialising repeated heads: with heads packed as b * H + h, that is
// exactly batch b's KV head h / (H / H_kv).
//
// What bounds it on this card: attention does 4 * d operations per
// unmasked (query, key) pair and moves 8 * d bytes per row in bf16 (q, k, v
// read once, out written once).  For a causal run of length n that is about
// n / 4 operations per byte: below the H100's ~295 op/byte ridge at every
// length the engine prefills (32..1024), so the least time is set by the
// bytes; at 2048 and beyond, and without the causal cut, the tensor cores
// set it.
//
// Two kernels, chosen by dtype in rtt_flash_fwd (never one as a fallback
// for the other):
//
// bf16 -> `flash_fwd_mma_kernel`, on the tensor cores (flash_mma.cuh has
// the tile mechanics):
//   * one block of 4 warps per (bh, 64-row query tile), each warp 16 query
//     rows; heavy causal tiles first (grid y walks the query tiles from the
//     last), so the short tiles fill the tail of the launch;
//   * K and V tiles of 64 rows stay bf16 in a 2-stage ring of dynamic
//     shared memory, filled by 16-byte cp.async copies, so tile j + 1 loads
//     while tile j computes; rows past seq_k are zero-filled by the copy;
//   * S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with f32
//     sums; Q is read into A fragments once, K as the B operand by
//     ldmatrix, V by ldmatrix.trans from the same row-major tile;
//   * the scores are scaled in f32 after the product, with log2(e) folded
//     in for exp2f; row max and sum are reduced over the 4 lanes of a row;
//     P is rounded to bf16 in registers as the A operand of P V, while l
//     sums the f32 p;
//   * only the diagonal tile and the tile at the seq_k edge are masked, and
//     a masked pair gets p = 0 exactly.
//
// float32 -> `flash_fwd_kernel`, scalar f32 FMA, which keeps the float32
// path exact to the reference up to summation order:
//   * one block per (bh, 64-row query tile), 4 threads per query row; each
//     thread keeps its quarter of the scaled query row and of the output
//     accumulator in registers for the whole KV sweep (O(seq) memory, no
//     score matrix in device memory);
//   * K and V are staged in shared memory 32 rows at a time and read back
//     as float4, so one shared-memory instruction feeds four FMAs; the 8
//     rows of a warp read the same address (broadcast);
//   * the partial dot products of one row are summed with two xor shuffles
//     among that row's 4 adjacent lanes only, so row statistics never mix
//     rows;
//   * causal blocks stop at the diagonal tile; the kernel masks the ragged
//     query and key edges itself and zero-fills K/V rows past seq_k, so a
//     masked column contributes exactly 0 (no garbage * 0 = NaN).
// wgmma, TMA staging and warp specialisation are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "flash_mma.cuh"

namespace {

constexpr int kBlockM = 64;         // query rows per block
constexpr int kBlockN = 32;         // key/value rows per shared-memory tile
constexpr int kThreadsPerRow = 4;   // lanes that share one query row
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

// Thread `part` of a row owns dims c * 16 + part * 4 + e (c < D / 16,
// e < 4): the 4 lanes of a row read 64 contiguous bytes of a K/V row.
// float32 only: bf16 takes the tensor-core kernel.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int group, int seq_q, int seq_k,
                 float sm_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kDims = D / kThreadsPerRow;  // dims per thread
  constexpr int kChunks = kDims / 4;         // float4 chunks per thread
  static_assert(2 * kBlockN * D * sizeof(float) <= 48 * 1024,
                "static shared memory is capped at 48 KB");
  __shared__ __align__(16) float k_tile[kBlockN][D];
  __shared__ __align__(16) float v_tile[kBlockN][D];

  const int bh = blockIdx.y;
  const int kv_bh = bh / group;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = q0 + tid / kThreadsPerRow;
  const bool row_ok = row < seq_q;

  float qr[kDims];
  float acc[kDims];
  const float* q_row = q + ((size_t)bh * seq_q + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = c * 16 + part * 4 + e;
      // the reference scales q in f32 before the product (attention.py:57)
      qr[c * 4 + e] = row_ok ? q_row[dim] * sm_scale : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }

  float m = kNegInf;
  float l = 0.f;
  const float* k_base = k + (size_t)kv_bh * seq_k * D;
  const float* v_base = v + (size_t)kv_bh * seq_k * D;
  int n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  if (kCausal) {
    // only tiles at or before this block's last query row take part
    n_tiles = min(n_tiles, (q0 + kBlockM + kBlockN - 1) / kBlockN);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBlockN;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      const int kr = kv0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < seq_k) {
        kx = k_base[(size_t)kr * D + c];
        vx = v_base[(size_t)kr * D + c];
      }
      k_tile[r][c] = kx;
      v_tile[r][c] = vx;
    }
    __syncthreads();

    float s[kBlockN];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&k_tile[j][c * 16 + part * 4]);
        dot = fmaf(qr[c * 4 + 0], kk.x, dot);
        dot = fmaf(qr[c * 4 + 1], kk.y, dot);
        dot = fmaf(qr[c * 4 + 2], kk.z, dot);
        dot = fmaf(qr[c * 4 + 3], kk.w, dot);
      }
      // sum over the row's 4 adjacent lanes (xor 1, 2 stay inside the group)
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int col = kv0 + j;
      const bool masked = col >= seq_k || (kCausal && col > row);
      s[j] = masked ? kNegInf : dot;
      m_cur = fmaxf(m_cur, s[j]);
    }

    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const float p = expf(s[j] - m_new);
      p_sum += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_tile[j][c * 16 + part * 4]);
        acc[c * 4 + 0] = fmaf(p, vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(p, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(p, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(p, vv.w, acc[c * 4 + 3]);
      }
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (!row_ok) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  float* o_row = out + ((size_t)bh * seq_q + row) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o_row[c * 16 + part * 4 + e] = acc[c * 4 + e] / l_safe;
    }
  }
  if (part == 0) {
    lse[(size_t)bh * seq_q + row] = (l == 0.f) ? -kNegInf : m + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int bh, int group, int seq_q, int seq_k,
                   bool causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid((seq_q + kBlockM - 1) / kBlockM, bh);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  if (causal) {
    flash_fwd_kernel<D, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lse, group, seq_q, seq_k, sm_scale);
  } else {
    flash_fwd_kernel<D, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lse, group, seq_q, seq_k, sm_scale);
  }
  return cudaGetLastError();
}

// Shared memory of the bf16 kernel: the Q tile, then a 2-stage ring of
// (K tile, V tile); 25,600 / 46,080 / 87,040 bytes at D = 32 / 64 / 128.
template <int D>
constexpr int fwd_mma_smem_bytes() {
  return 5 * rtt_mma::Tile<D>::kBytes;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(rtt_mma::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int group, int seq_q, int seq_k, float scale_log2) {
  using namespace rtt_mma;
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* ring = q_s + Tile<D>::kElems;  // stage s: K at 2s, V at 2s + 1

  const int bh = blockIdx.x;
  const int kv_bh = bh / group;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = q_tile * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // this lane's rows: a, a+8

  const bf16* k_base = k + (size_t)kv_bh * seq_k * D;
  const bf16* v_base = v + (size_t)kv_bh * seq_k * D;
  int n_tiles = (seq_k + kRows - 1) / kRows;
  // only tiles at or before this block's last query row take part
  if (kCausal) n_tiles = min(n_tiles, q_tile + 1);

  load_tile<D>(q_s, q + (size_t)bh * seq_q * D, q0, seq_q, tid);
  if (n_tiles > 0) {
    load_tile<D>(ring, k_base, 0, seq_k, tid);
    load_tile<D>(ring + Tile<D>::kElems, v_base, 0, seq_k, tid);
  }
  cp_async_commit();

  uint32_t qf[D / 16][4];   // Q A fragments, read once
  float o[D / 8][4];        // O, f32, rows a and a + 8
  float m[2] = {kNegInf, kNegInf};  // running max of the log2-scaled scores
  float l[2] = {0.f, 0.f};  // this lane's part of the running sum
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // prefetch tile j + 1 into the other stage
      bf16* st = ring + 2 * ((j + 1) & 1) * Tile<D>::kElems;
      load_tile<D>(st, k_base, (j + 1) * kRows, seq_k, tid);
      load_tile<D>(st + Tile<D>::kElems, v_base, (j + 1) * kRows, seq_k, tid);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile j (and Q) landed for this thread...
    __syncthreads();     // ...and for every thread
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a<D>(qf[kk], smem_u32(q_s), warp * 16, kk * 16, lane);
      }
    }
    const uint32_t k_s = smem_u32(ring + 2 * (j & 1) * Tile<D>::kElems);
    const uint32_t v_s = k_s + Tile<D>::kBytes;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles
    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t b[4];
        load_b_keys<D>(b, k_s, np * 16, kk * 16, lane);
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale in f32 after the product; mask only the diagonal / edge tile
    const int kv0 = j * kRows;
    const bool edge = kv0 + kRows > seq_k || (kCausal && kv0 + kRows - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge && masked<kCausal>(kv0, nt, e, t, row_a, seq_k)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    }
    // p = exp2(s - m), exactly 0 where masked; l sums the f32 p
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - m[e >> 1]);
        if (edge && s[nt][e] == kNegInf) p = 0.f;
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        load_b_dims<D>(b, v_s, kk * 16, np * 16, lane);
        mma(o[2 * np], a, b[0], b[1]);
        mma(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1 before refill
  }

  cp_async_wait<0>();  // no copy outlives the block (seq_k == 0)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];  // a row that saw no column: 0
  }
  store_rows<D>(out + (size_t)bh * seq_q * D, o, row_a, seq_q, t, inv[0],
                inv[1]);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row < seq_q) {
        lse[(size_t)bh * seq_q + row] =
            l[i] == 0.f ? -kNegInf : m[i] * kLn2 + logf(l[i]);
      }
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int bh, int group, int seq_q, int seq_k,
                       bool causal, float sm_scale, cudaStream_t stream) {
  const int tiles = (seq_q + rtt_mma::kRows - 1) / rtt_mma::kRows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(bh, tiles);
  constexpr int smem = fwd_mma_smem_bytes<D>();
  const float scale_log2 = sm_scale * rtt_mma::kLog2e;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto kernel = causal ? flash_fwd_mma_kernel<D, true>
                       : flash_fwd_mma_kernel<D, false>;
  const cudaError_t rc = rtt_mma::allow_smem(kernel, smem);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, rtt_mma::kThreads, smem, stream>>>(
      qp, kp, vp, op, lse, group, seq_q, seq_k, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); the caller raises on anything else.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int bh_kv,
                             int seq_q, int seq_k, int head_dim, int causal,
                             float sm_scale, int dtype, void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || bh > 65535 || seq_q < 0 ||
      seq_k < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (seq_q == 0) return (int)cudaSuccess;
  const int group = bh / bh_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_p = static_cast<float*>(lse);
  const bool c = causal != 0;
#define RTT_FWD_ARGS \
  q, k, v, out, lse_p, bh, group, seq_q, seq_k, c, sm_scale, s
  if (dtype == 0) {  // float32: the scalar kernel
    switch (head_dim) {
      case 32: return (int)launch<32>(RTT_FWD_ARGS);
      case 64: return (int)launch<64>(RTT_FWD_ARGS);
      case 128: return (int)launch<128>(RTT_FWD_ARGS);
    }
  } else if (dtype == 1) {  // bfloat16: the tensor-core kernel
    switch (head_dim) {
      case 32: return (int)launch_mma<32>(RTT_FWD_ARGS);
      case 64: return (int)launch_mma<64>(RTT_FWD_ARGS);
      case 128: return (int)launch_mma<128>(RTT_FWD_ARGS);
    }
  }
#undef RTT_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
