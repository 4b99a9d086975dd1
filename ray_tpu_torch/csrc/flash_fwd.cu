// Flash-attention forward for Hopper (sm_90a): causal or full attention
// with an online softmax; emits O and the per-row logsumexp.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/flash_attention.py:48
// (_fwd_kernel, pallas_call at :135). Same contract: q arrives pre-scaled
// and rounded to the storage dtype (the wrapper does it, as _flash_impl
// does); query head h reads KV head h / n_rep; masked scores use the finite
// -1e9 and the running max starts at -1e30; p is rounded to v's dtype
// before the PV product; rows that see no key get O = 0 and LSE = -inf.
// Unlike the TPU kernel it reads q/k/v and writes O in the model's
// [B, S, H, D] layout directly (each row is D contiguous elements), so no
// transposed copies are made, and S may be any length: the ragged last
// tile is masked.
//
// What bounds it on the H100: operations, 4 * B * H * D * S(S+1)/2 flops
// causal (q . k^T and p . v) against O(S * D * H) bytes, hundreds of flops
// per byte at S >= 512. Two instantiations:
//
// bf16 (flash_fwd_wgmma_kernel, both main paths): the tensor cores.
// - One block of two warpgroups per (b * h, 128-row query tile), the
//   heaviest causal tiles launched first; each warpgroup owns 64 rows.
// - K and V tiles of 128 keys stream through a two-stage cp.async ring
//   (the next tile loads while this one is multiplied), only up to the
//   diagonal when causal, into the 128-byte-swizzled layout of
//   wgmma_tile.cuh.
// - S = q . k^T is wgmma m64n128k16 from shared memory (both K-major);
//   the online softmax runs on the accumulator fragment (a row lives in
//   the 4 threads of a quad: two shuffles), with exp2 and log2(e) folded
//   in, LSE still in natural log; only tiles the diagonal crosses and the
//   ragged last tile are masked.
// - p is rounded to bf16 in registers and is the A operand of the p . v
//   wgmma (v read MN-major through the transpose bit): s and p never touch
//   shared memory.
// Not yet done: warp specialisation (a producer warp issuing TMA), the
// overlap of one tile's softmax with the next tile's q . k^T, and a
// persistent grid (ROADMAP.md, Queue 2).
//
// fp32 (flash_fwd_kernel): scalar FMAs, one block of 256 threads per
// (b * h, 64-row q tile), each thread a 4 x 4 patch of the scores and a
// 4 x (D/16) patch of O. wgmma takes no fp32 input and TF32 would change
// the answer, so fp32 callers get this kernel; neither main path launches
// it. It shares no tile code with the bf16 kernel and proves nothing about
// it: the bf16 kernel is held to its own plain version, at a tolerance set
// from its measured error (chip_smoke.py).

#include <cmath>
#include <cstddef>

#include "common.cuh"
#include "wgmma_tile.cuh"


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

// ------------------------------------------------- bf16, tensor cores
namespace wg {

constexpr int kThreads = 256;  // two warpgroups
constexpr int TQ = 128;        // query rows per block, 64 per warpgroup
constexpr int TK = 128;        // keys per K/V tile
constexpr int kTile = tile::tile_bytes(128);  // one [128, 128] bf16 tile
// q, then two ring stages of (k, v); plus the alignment slack.
constexpr int kSmem = 5 * kTile + tile::kAtomBytes;
constexpr float kLog2e = 1.4426950408889634f;

// s = q . k^T for this warpgroup's 64 rows and a 128-key tile: 8 steps
// over D, q and k both K-major. Started, not waited for.
__device__ __forceinline__ void start_scores(float (&s)[64], const uint8_t* q_s,
                                             const uint8_t* ks, int wg) {
  using namespace tile;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n128k16_ss<0, 0>(s, desc_k_major(q_s, TQ, 64 * wg, kk),
                              desc_k_major(ks, TK, 0, kk), 1);
  wgmma_commit();
}

// o += p . v over a 128-key tile: p as bf16 registers, v MN-major.
// Started, not waited for.
__device__ __forceinline__ void start_pv(float (&o)[64],
                                         const uint32_t (&p)[8][4],
                                         const uint8_t* vs) {
  using namespace tile;
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma_m64n128k16_rs<1>(o, p[kk], desc_mn_major(vs, TK, 0, kk), 1);
  wgmma_commit();
}

// Mask (when `diag`, or in the ragged last tile) and the online softmax of
// one score tile on its fragment: row r's values are s[4 j + 2 r + e] in
// the four threads of a quad (two shuffles per reduction). s becomes p;
// m and l move on; alpha[r] is what o's row r must be scaled by.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int qrow, int col,
                                             int seq, bool diag) {
  if (diag || k0 + TK > seq) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i >> 2) + col + (i & 1);
      const int qpos = qrow + 8 * ((i >> 1) & 1);
      if (key >= seq || (diag && key > qpos)) s[i] = kMask;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = s[2 * r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = group_max<4>(mx);
    const float m_new = fmaxf(m[r], mx);
    const float ml = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = exp2f(fmaf(s[4 * j + 2 * r + e], kLog2e, -ml));
        s[4 * j + 2 * r + e] = pv;
        sum += pv;
      }
    sum = group_sum<4>(sum);
    alpha[r] = exp2f((m[r] - m_new) * kLog2e);
    l[r] = alpha[r] * l[r] + sum;
    m[r] = m_new;
  }
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      o[4 * j + 2 * r] *= alpha[r];
      o[4 * j + 2 * r + 1] *= alpha[r];
    }
}

__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, S, H, 128], pre-scaled
    const __nv_bfloat16* __restrict__ k,  // [B, S, Hkv, 128]
    const __nv_bfloat16* __restrict__ v,  // [B, S, Hkv, 128]
    __nv_bfloat16* __restrict__ out,      // [B, S, H, 128]
    float* __restrict__ lse,              // [B * H, S]
    int seq, int n_heads, int n_kv, int causal) {
  using namespace tile;
  constexpr int D = 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_smem(smem_raw);
  uint8_t* k_s = q_s + kTile;      // stage i at k_s + i * kTile
  uint8_t* v_s = k_s + 2 * kTile;  // stage i at v_s + i * kTile

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / n_heads, h = bh % n_heads;
  const int hk = h / (n_heads / n_kv);
  const int q0 = qt * TQ;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int col = 2 * (lane & 3);  // accumulator columns 8 j + col + {0, 1}
  // This thread's query rows: qrow and qrow + 8.
  const int qrow = q0 + 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);

  const size_t q_row = (size_t)n_heads * D;  // stride between positions
  const size_t kv_row = (size_t)n_kv * D;
  const __nv_bfloat16* qb = q + (size_t)b * seq * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * seq * kv_row + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * seq * kv_row + (size_t)hk * D;

  int n_kt = (seq + TK - 1) / TK;
  if (causal) n_kt = min(n_kt, (q0 + TQ - 1) / TK + 1);

  load_tile<TQ, kThreads>(q_s, qb, q_row, q0, seq, tid);
  load_tile<TK, kThreads>(k_s, kb, kv_row, 0, seq, tid);
  load_tile<TK, kThreads>(v_s, vb, kv_row, 0, seq, tid);
  cp_async_commit();

  float o[64];
  float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    const uint8_t* ks = k_s + (kt & 1) * kTile;
    const uint8_t* vs = v_s + (kt & 1) * kTile;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile kt has landed; tile kt - 1 is no longer read
    if (kt + 1 < n_kt) {  // the next tile loads while this one is used
      load_tile<TK, kThreads>(k_s + ((kt + 1) & 1) * kTile, kb, kv_row,
                              k0 + TK, seq, tid);
      load_tile<TK, kThreads>(v_s + ((kt + 1) & 1) * kTile, vb, kv_row,
                              k0 + TK, seq, tid);
      cp_async_commit();
    }

    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    start_scores(s, q_s, ks, wg);
    wgmma_wait<0>();
    fence_regs(s);
    float alpha[2];
    softmax_tile(s, m, l, alpha, k0, qrow, col, seq,
                 causal && k0 + TK - 1 > q0 + 64 * wg);
    rescale(o, alpha);
    uint32_t p[8][4];
    acc_to_a<128>(s, p);
    fence_regs(o);
    wgmma_fence();
    start_pv(o, p, vs);
    wgmma_wait<0>();
    fence_regs(o);
    fence_words(p);
  }

  __nv_bfloat16* ob = out + (size_t)b * seq * q_row + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_pos = qrow + 8 * r;
    if (s_pos >= seq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = ob + (size_t)s_pos * q_row + col;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                o[4 * j + 2 * r + 1] / denom);
    if ((lane & 3) == 0)
      lse[(size_t)bh * seq + s_pos] =
          l[r] == 0.f ? -INFINITY : m[r] + logf(denom);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int seq, int n_heads, int n_kv,
                   int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * n_heads, (seq + TQ - 1) / TQ);
  flash_fwd_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), seq,
      n_heads, n_kv, causal);
  return cudaGetLastError();
}

}  // namespace wg

// The one head size built: that of the models the port serves on the card.
constexpr int kHeadDim = 128;

}  // namespace
}  // namespace rtt

// C entry point bound with ctypes. Returns the launch's cudaError_t. The
// dtype picks the kernel: bf16 always takes the tensor-core kernel, fp32
// the scalar one.
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
    return rtt::wg::launch(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                           causal, s);
  return cudaErrorInvalidValue;
}
