// Flash-attention forward for Hopper (sm_90a): causal or full attention
// with an online softmax; emits O and the per-row logsumexp.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/flash_attention.py
// (_fwd_kernel, launched by _fwd_call). Same contract: q arrives
// pre-scaled and rounded to the storage dtype (the wrapper does it, as
// _flash_impl does); query head h reads KV head h / n_rep; masked scores
// use the finite -1e9 and the running max starts at -1e30; p is rounded to
// v's dtype before the PV product; rows that see no key get O = 0 and
// LSE = -inf. Unlike the TPU kernel it reads q/k/v and writes O in the
// model's [B, S, H, D] layout directly (each row is D contiguous
// elements), so no transposed copies are made, and S may be any length:
// the ragged last tile is masked.
//
// What bounds it on the H100: operations. A causal pass does
// 2 * S^2 * D * H flops against O(S * D * H) bytes, hundreds of flops per
// byte at S >= 512. The design keeps the S x S scores out of device memory:
//
// - one block of 256 threads per (b * h, 64-row q tile); it walks the kv
//   tiles of 64 keys up to the diagonal only (tiles above it are never
//   loaded) and masks only the diagonal tile and the ragged last tile;
// - each thread owns a 4 x 4 patch of the score tile and a 4 x (D/16)
//   patch of the O accumulator, both in registers; the 16 threads that
//   share a row are one half-warp, so row max and row sum are shuffles;
// - q and K tiles sit in shared memory as fp32 with a padded row stride,
//   so the 16 lanes of a half-warp read 16 different banks.
//
// This first version multiplies with scalar fp32 FMAs, far from the
// 989 TFLOP/s bf16 tensor-core rate that bounds the work. wgmma on the
// q/K and p/V tiles, with TMA loads, is the next step.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace rtt {
namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per kv tile
constexpr int PS = BK + 1;  // padded row stride of the probability tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,  // [B, S, H, D], pre-scaled
    const T* __restrict__ k,  // [B, S, Hkv, D]
    const T* __restrict__ v,  // [B, S, Hkv, D]
    T* __restrict__ out,      // [B, S, H, D]
    float* __restrict__ lse,  // [B * H, S]
    int seq, int n_heads, int n_kv, int causal) {
  constexpr int KS = D + 1;  // padded fp32 row stride of q_s and k_s
  constexpr int DJ = D / 16;  // O columns per thread
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int hk = h / (n_heads / n_kv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group; the 16 tx of a row share a half-warp
  const int ty = tid >> 4;  // row group

  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][KS]
  float* k_s = q_s + BQ * KS;     // [BK][KS]
  float* p_s = k_s + BK * KS;     // [BQ][PS]
  T* v_s = reinterpret_cast<T*>(p_s + BQ * PS);  // [BK][D]

  const size_t q_row = (size_t)n_heads * D;  // stride between positions
  const size_t kv_row = (size_t)n_kv * D;
  const T* qb = q + (size_t)b * seq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * seq * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * seq * kv_row + (size_t)hk * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    q_s[r * KS + d] = s < seq ? to_float(qb[(size_t)s * q_row + d]) : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (seq + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      const bool in = s < seq;
      k_s[c * KS + d] = in ? to_float(kb[(size_t)s * kv_row + d]) : 0.f;
      v_s[i] = in ? vb[(size_t)s * kv_row + d] : from_float<T>(0.f);
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * KS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // Mask only the tiles the diagonal crosses and the ragged last tile.
    const bool diag = causal && k0 + BK - 1 > q0;
    if (diag || k0 + BK > seq) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key >= seq || (diag && key > q0 + ty + 16 * i))
            sc[i][j] = kMask;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
      mx = group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      sum = group_sum<16>(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = to_float(v_s[c * D + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + (size_t)b * seq * q_row + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= seq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)s * q_row + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    if (tx == 0)
      lse[(size_t)bh * seq + s] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int seq, int n_heads, int n_kv,
                   int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + BQ * PS) +
                      sizeof(T) * (size_t)BK * D;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BQ - 1) / BQ, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), seq, n_heads, n_kv, causal);
  return cudaGetLastError();
}

// The one head size built: that of the models the port serves on the card.
constexpr int kHeadDim = 128;

}  // namespace
}  // namespace rtt

// C entry point bound with ctypes. Returns the launch's cudaError_t.
extern "C" int rtt_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* out, void* lse, int batch,
                             int seq, int n_heads, int n_kv, int head_dim,
                             int causal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim != rtt::kHeadDim) return cudaErrorInvalidValue;
  if (dtype == rtt::kFloat32)
    return rtt::launch<float, rtt::kHeadDim>(q, k, v, out, lse, batch, seq,
                                             n_heads, n_kv, causal, s);
  if (dtype == rtt::kBFloat16)
    return rtt::launch<__nv_bfloat16, rtt::kHeadDim>(
        q, k, v, out, lse, batch, seq, n_heads, n_kv, causal, s);
  return cudaErrorInvalidValue;
}
