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
// set it.  This first version reaches neither: it is scalar f32 FMA, which
// keeps the float32 path exact to the reference, and at short lengths its
// time is the launch and the few blocks in flight.  What the design does:
//   * one block per (bh, 64-row query tile), 4 threads per query row; each
//     thread keeps its quarter of the scaled query row and of the output
//     accumulator in registers for the whole KV sweep (O(seq) memory, no
//     score matrix in device memory);
//   * K and V are staged in shared memory 32 rows at a time, converted to
//     f32 once, and read back as float4 so one shared-memory instruction
//     feeds four FMAs; the 8 rows of a warp read the same address (broadcast);
//   * the partial dot products of one row are summed with two xor shuffles
//     among that row's 4 adjacent lanes only, so row statistics never mix
//     rows;
//   * causal blocks stop at the diagonal tile; the kernel masks the ragged
//     query and key edges itself and zero-fills K/V rows past seq_k, so a
//     masked column contributes exactly 0 (no garbage * 0 = NaN).
// Tensor-core products (mma.sync / wgmma), TMA staging and warp
// specialisation are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kBlockM = 64;         // query rows per block
constexpr int kBlockN = 32;         // key/value rows per shared-memory tile
constexpr int kThreadsPerRow = 4;   // lanes that share one query row
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Thread `part` of a row owns dims c * 16 + part * 4 + e (c < D / 16,
// e < 4): the 4 lanes of a row read 64 contiguous bytes of a K/V row.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
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
  const T* q_row = q + ((size_t)bh * seq_q + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = c * 16 + part * 4 + e;
      // the reference scales q in f32 before the product (attention.py:57)
      qr[c * 4 + e] = row_ok ? to_float(q_row[dim]) * sm_scale : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }

  float m = kNegInf;
  float l = 0.f;
  const T* k_base = k + (size_t)kv_bh * seq_k * D;
  const T* v_base = v + (size_t)kv_bh * seq_k * D;
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
        kx = to_float(k_base[(size_t)kr * D + c]);
        vx = to_float(v_base[(size_t)kr * D + c]);
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
  T* o_row = out + ((size_t)bh * seq_q + row) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o_row[c * 16 + part * 4 + e] = from_float<T>(acc[c * 4 + e] / l_safe);
    }
  }
  if (part == 0) {
    lse[(size_t)bh * seq_q + row] = (l == 0.f) ? -kNegInf : m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int bh, int group, int seq_q, int seq_k,
                   bool causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid((seq_q + kBlockM - 1) / kBlockM, bh);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (causal) {
    flash_fwd_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lse, group, seq_q, seq_k, sm_scale);
  } else {
    flash_fwd_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lse, group, seq_q, seq_k, sm_scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         void* out, float* lse, int bh, int group, int seq_q,
                         int seq_k, int head_dim, bool causal, float sm_scale,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, bh, group, seq_q, seq_k, causal,
                           sm_scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, bh, group, seq_q, seq_k, causal,
                           sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, bh, group, seq_q, seq_k,
                            causal, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  switch (dtype) {
    case 0:
      return (int)dispatch_dim<float>(q, k, v, out, lse_p, bh, group, seq_q,
                                      seq_k, head_dim, causal != 0, sm_scale,
                                      s);
    case 1:
      return (int)dispatch_dim<__nv_bfloat16>(q, k, v, out, lse_p, bh, group,
                                              seq_q, seq_k, head_dim,
                                              causal != 0, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
