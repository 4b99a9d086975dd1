// Paged decode / speculative-verify attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/paged_attention.py
// (_make_kernel -> _kernel, launched by paged_attention). Same function:
// query token k of slot b attends the key cells at positions
// <= positions[b] + k of the pages its block table lists, with an fp32
// online softmax; table entries of -1 read the dump page 0.
//
// What bounds it on the H100: bytes. Each step reads every live K/V page
// of every slot once (2 * pages * Hkv * P * Dh * 2 bytes in bf16) and does
// only 2 * n_rep * K flops per K/V element (8 at 32/8 heads and K = 1, so 4
// per byte), far below the ~295 flops per byte where the tensor cores
// would become the limit. So the design reads each page once per KV head
// and never repeats K/V across the query group:
//
// - one block per (KV head, slot); the block holds the group's
//   n_rep * K query rows (4 at K=1 for 32/8 heads), so a page tile is
//   loaded from device memory once and used by all of them;
// - the block walks pages 0 .. lastp only (lastp from the slot's own
//   position), so unused table width costs nothing;
// - pages are staged in shared memory as fp32, K with a padded row stride
//   so that neighbouring threads reading neighbouring key cells hit
//   distinct banks.
//
// This first version uses scalar fp32 FMAs and no copy/compute overlap; at
// decode batch sizes the grid (Hkv * B blocks) is also smaller than the
// card. Splitting the page walk across blocks (flash-decoding) and
// cp.async double buffering are the next steps.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace rtt {
namespace {

constexpr int kThreads = 128;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q,           // [B, K, H, DH]
    const T* __restrict__ k_pool,      // [num_pages, Hkv, P, DH]
    const T* __restrict__ v_pool,      // [num_pages, Hkv, P, DH]
    const int* __restrict__ tables,    // [B, max_pages], -1 = unused
    const int* __restrict__ positions, // [B]
    T* __restrict__ out,               // [B, K, H, DH]
    int kq, int n_heads, int n_kv, int page_size, int max_pages,
    float scale) {
  constexpr int KS = DH + 1;  // padded fp32 row stride of q_s and k_s
  const int g = blockIdx.x;   // KV head
  const int b = blockIdx.y;   // slot
  const int n_rep = n_heads / n_kv;
  const int rows = n_rep * kq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                      // [rows][KS]
  float* k_s = q_s + rows * KS;           // [P][KS]
  float* v_s = k_s + page_size * KS;      // [P][DH]
  float* p_s = v_s + page_size * DH;      // [rows][P] scores, then probs
  float* acc_s = p_s + rows * page_size;  // [rows][DH]
  float* m_s = acc_s + rows * DH;         // [rows] running max
  float* l_s = m_s + rows;                // [rows] running denominator
  float* a_s = l_s + rows;                // [rows] this page's rescale

  const int pos = positions[b];
  // Row r = h_rep * K + k holds query token k of head g * n_rep + h_rep,
  // so r % K is the query's offset from pos.
  for (int i = tid; i < rows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int h = g * n_rep + r / kq, kk = r % kq;
    q_s[r * KS + d] =
        to_float(q[((size_t)(b * kq + kk) * n_heads + h) * DH + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kMInit;
    l_s[r] = 0.f;
  }
  const int lastp = min(max((pos + kq - 1) / page_size, 0), max_pages - 1);
  const int* table = tables + (size_t)b * max_pages;
  const size_t tile = (size_t)page_size * DH;
  __syncthreads();

  for (int ip = 0; ip <= lastp; ++ip) {
    const int page = max(table[ip], 0);
    const T* kt = k_pool + ((size_t)page * n_kv + g) * tile;
    const T* vt = v_pool + ((size_t)page * n_kv + g) * tile;
    for (int i = tid; i < page_size * DH; i += kThreads) {
      k_s[(i / DH) * KS + i % DH] = to_float(kt[i]);
      v_s[i] = to_float(vt[i]);
    }
    __syncthreads();

    // Scores, scaled here (q is not pre-scaled), masked past each query.
    for (int i = tid; i < rows * page_size; i += kThreads) {
      const int r = i / page_size, c = i % page_size;
      const float* qr = q_s + r * KS;
      const float* kc = k_s + c * KS;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kc[d], s);
      s *= scale;
      if (ip * page_size + c > pos + r % kq) s = kMask;
      p_s[i] = s;
    }
    __syncthreads();

    // Online softmax update, one warp per row.
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* pr = p_s + r * page_size;
      float mx = kMInit;
      for (int c = lane; c < page_size; c += 32) mx = fmaxf(mx, pr[c]);
      mx = group_max<32>(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < page_size; c += 32) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = round_to<T>(p);  // p in v's dtype for the PV product
      }
      sum = group_sum<32>(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const float* pr = p_s + r * page_size;
      float a = 0.f;
      for (int c = 0; c < page_size; ++c) a = fmaf(pr[c], v_s[c * DH + d], a);
      acc_s[i] = acc_s[i] * a_s[r] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int h = g * n_rep + r / kq, kk = r % kq;
    const float l = l_s[r];
    out[((size_t)(b * kq + kk) * n_heads + h) * DH + d] =
        from_float<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* positions, void* out,
                   int batch, int kq, int n_heads, int n_kv, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  const int rows = (n_heads / n_kv) * kq;
  const size_t smem =
      sizeof(float) * ((size_t)rows * (DH + 1) + (size_t)page_size * (DH + 1) +
                       (size_t)page_size * DH + (size_t)rows * page_size +
                       (size_t)rows * DH + 3 * (size_t)rows);
  auto kernel = paged_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_kv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), kq, n_heads,
      n_kv, page_size, max_pages, scale);
  return cudaGetLastError();
}

// The one head size built: that of the models the port serves on the card.
constexpr int kHeadDim = 128;

}  // namespace
}  // namespace rtt

// C entry point bound with ctypes. Returns the launch's cudaError_t.
extern "C" int rtt_paged_attention(int dtype, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* tables, const void* positions,
                                   void* out, int batch, int kq, int n_heads,
                                   int n_kv, int head_dim, int page_size,
                                   int max_pages, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim != rtt::kHeadDim) return cudaErrorInvalidValue;
  if (dtype == rtt::kFloat32)
    return rtt::launch<float, rtt::kHeadDim>(
        q, k_pool, v_pool, tables, positions, out, batch, kq, n_heads, n_kv,
        page_size, max_pages, scale, s);
  if (dtype == rtt::kBFloat16)
    return rtt::launch<__nv_bfloat16, rtt::kHeadDim>(
        q, k_pool, v_pool, tables, positions, out, batch, kq, n_heads, n_kv,
        page_size, max_pages, scale, s);
  return cudaErrorInvalidValue;
}
