// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of causal or
// full attention, recomputing the probabilities from the forward's saved
// per-row logsumexp.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/flash_attention.py
// (_bwd_kernel, launched by _flash_bwd). Same arithmetic, not the same
// blocking:
//
// - q arrives pre-scaled and rounded to the storage dtype (the wrapper does
//   it, as _flash_bwd does), so s = qs . k^T matches the forward's scores
//   and dk = ds^T . qs needs no extra scale; dq = (ds . k) * scale in fp32,
//   then cast.
// - delta = rowsum(dO * O) comes in as fp32 [B * H, S], computed by the
//   wrapper as a torch op, as the reference computes it outside its kernel.
// - p = exp(s - lse) under the forward's finite -1e9 mask; p is rounded to
//   dO's dtype before p^T . dO, and ds = p * (dp - delta) to the q/k dtype
//   before ds . k and ds^T . qs. Every product accumulates in fp32.
// - GQA: query head h reads KV head h / n_rep by index. The reference writes
//   dk and dv per query head, rounds them to the storage dtype and sums each
//   group afterwards; here one block sums the group's n_rep heads in fp32
//   registers and rounds once, writing [B, S, Hkv, D] directly.
// - The TPU kernel's dq slab / fp32 partials split exists for VMEM and is
//   not carried over. dq comes from a second, deterministic pass (FA2 style):
//
//   dkdv pass: one block of 256 threads per (b * Hkv, 64-key tile). K and V
//     stay in shared memory; the block walks the group's query heads and,
//     for each, the 64-row query tiles from the diagonal on (causal), and
//     accumulates dk and dv for its 64 keys in registers.
//   dq pass: one block per (b * H, 64-row query tile), walking the kv tiles
//     up to the diagonal, accumulating dq in registers. The heaviest tiles
//     (last rows, causal) are launched first.
//
// Reads the model's [B, S, H, D] layout by stride (each row is D contiguous
// elements), so no transposed copies are made; S may be any length, the
// ragged last tile being masked (keys) and zeroed (query rows).
//
// What bounds it on the H100: operations. The fused backward does five
// S x S x D products per head (10 * B * H * D * S(S+1)/2 flops causal)
// against O(S * D * H) bytes. This first version recomputes s and dp in the
// dq pass (seven products instead of five) and multiplies with scalar fp32
// FMAs, far from the 989 TFLOP/s bf16 tensor-core rate; wgmma on the tiles,
// with TMA loads and one fused pass, is the next step.

#include <cstddef>

#include "common.cuh"

namespace rtt {
namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int PS = BK + 1;  // padded row stride of a 64 x 64 tile

// A [64, D] tile of rows s0 .. s0 + 63 of one head into fp32 shared memory
// (padded row stride D + 1); rows at or past seq read as 0. `src` points at
// the head's first element; `row` is the stride between positions.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t row, int s0, int seq,
                                          int tid) {
  constexpr int KS = D + 1;
  for (int i = tid; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r;
    dst[r * KS + d] = s < seq ? to_float(src[(size_t)s * row + d]) : 0.f;
  }
}

// s = q . k^T and dp = dO . v^T for one (query tile, key tile) pair. The
// thread (ty, tx) owns query rows ty + 16 i and keys tx + 16 j; the 16 tx of
// a row are one half-warp and read 16 different banks of k_s and v_s.
template <int D>
__device__ __forceinline__ void scores_and_dp(const float* q_s,
                                              const float* do_s,
                                              const float* k_s,
                                              const float* v_s, int ty,
                                              int tx, float sc[4][4],
                                              float dp[4][4]) {
  constexpr int KS = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = q_s[(ty + 16 * i) * KS + d];
      gv[i] = do_s[(ty + 16 * i) * KS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = k_s[(tx + 16 * j) * KS + d];
      vv[j] = v_s[(tx + 16 * j) * KS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

// p = exp(s - lse) under the forward's mask (keys past the diagonal or past
// seq get -1e9, whose exp underflows to 0) and 0 on query rows past seq;
// sc becomes p and dp becomes ds = p * (dp - delta), both in fp32.
__device__ __forceinline__ void probs_and_ds(float sc[4][4], float dp[4][4],
                                             const float lse[4],
                                             const float delta[4], int q0,
                                             int k0, int seq, bool diag,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const float s =
          key >= seq || (diag && key > qpos) ? kMask : sc[i][j];
      const float p = qpos < seq ? expf(s - lse[i]) : 0.f;
      sc[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q,      // [B, S, H, D], pre-scaled
    const T* __restrict__ k,      // [B, S, Hkv, D]
    const T* __restrict__ v,      // [B, S, Hkv, D]
    const T* __restrict__ dout,   // [B, S, H, D]
    const float* __restrict__ lse,    // [B * H, S]
    const float* __restrict__ delta,  // [B * H, S]
    T* __restrict__ dk,           // [B, S, Hkv, D]
    T* __restrict__ dv,           // [B, S, Hkv, D]
    int seq, int n_heads, int n_kv, int causal) {
  constexpr int KS = D + 1;
  constexpr int DJ = D / 16;  // columns of D per thread
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / n_kv, hk = blockIdx.y % n_kv;
  const int n_rep = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* k_s = smem;                // [BK][KS]
  float* v_s = k_s + BK * KS;       // [BK][KS]
  float* q_s = v_s + BK * KS;       // [BQ][KS]
  float* do_s = q_s + BQ * KS;      // [BQ][KS]
  float* p_s = do_s + BQ * KS;      // [BQ][PS], p rounded to T
  float* ds_s = p_s + BQ * PS;      // [BQ][PS], ds rounded to T
  float* lse_s = ds_s + BQ * PS;    // [BQ]
  float* delta_s = lse_s + BQ;      // [BQ]

  const size_t q_row = (size_t)n_heads * D;  // stride between positions
  const size_t kv_row = (size_t)n_kv * D;
  const size_t kv_off = (size_t)b * seq * kv_row + (size_t)hk * D;
  load_tile<T, D>(k_s, k + kv_off, kv_row, k0, seq, tid);
  load_tile<T, D>(v_s, v + kv_off, kv_row, k0, seq, tid);

  // This thread's keys ty + 16 i, columns tx + 16 j.
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int n_qt = (seq + BQ - 1) / BQ;
  // Causal: query tiles wholly before this key tile see none of it.
  const int qt0 = causal ? k0 / BQ : 0;
  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const size_t bh = (size_t)b * n_heads + h;
    const size_t q_off = (size_t)b * seq * q_row + (size_t)h * D;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(q_s, q + q_off, q_row, q0, seq, tid);
      load_tile<T, D>(do_s, dout + q_off, q_row, q0, seq, tid);
      if (tid < BQ) {
        const int s = q0 + tid;
        lse_s[tid] = s < seq ? lse[bh * seq + s] : 0.f;
        delta_s[tid] = s < seq ? delta[bh * seq + s] : 0.f;
      }
      __syncthreads();

      float sc[4][4], dp[4][4], lse_r[4], delta_r[4];
      scores_and_dp<D>(q_s, do_s, k_s, v_s, ty, tx, sc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lse_r[i] = lse_s[ty + 16 * i];
        delta_r[i] = delta_s[ty + 16 * i];
      }
      const bool diag = causal && k0 + BK - 1 > q0;
      probs_and_ds(sc, dp, lse_r, delta_r, q0, k0, seq, diag, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ty + 16 * i) * PS + tx + 16 * j;
          p_s[at] = round_to<T>(sc[i][j]);
          ds_s[at] = round_to<T>(dp[i][j]);
        }
      __syncthreads();

      // dv += p^T . dO and dk += ds^T . qs over the tile's query rows c.
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pv[4], dsv[4], gv[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[c * PS + ty + 16 * i];
          dsv[i] = ds_s[c * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gv[j] = do_s[c * KS + tx + 16 * j];
          qv[j] = q_s[c * KS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= seq) continue;
    const size_t at = kv_off + (size_t)s * kv_row;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[at + tx + 16 * j] = from_float<T>(dk_acc[i][j]);
      dv[at + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q,      // [B, S, H, D], pre-scaled
    const T* __restrict__ k,      // [B, S, Hkv, D]
    const T* __restrict__ v,      // [B, S, Hkv, D]
    const T* __restrict__ dout,   // [B, S, H, D]
    const float* __restrict__ lse,    // [B * H, S]
    const float* __restrict__ delta,  // [B * H, S]
    T* __restrict__ dq,           // [B, S, H, D]
    int seq, int n_heads, int n_kv, int causal, float scale) {
  constexpr int KS = D + 1;
  constexpr int DJ = D / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int hk = h / (n_heads / n_kv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][KS]
  float* do_s = q_s + BQ * KS;    // [BQ][KS]
  float* k_s = do_s + BQ * KS;    // [BK][KS]
  float* v_s = k_s + BK * KS;     // [BK][KS]
  float* ds_s = v_s + BK * KS;    // [BQ][PS], ds rounded to T

  const size_t q_row = (size_t)n_heads * D;
  const size_t kv_row = (size_t)n_kv * D;
  const size_t q_off = (size_t)b * seq * q_row + (size_t)h * D;
  const size_t kv_off = (size_t)b * seq * kv_row + (size_t)hk * D;
  load_tile<T, D>(q_s, q + q_off, q_row, q0, seq, tid);
  load_tile<T, D>(do_s, dout + q_off, q_row, q0, seq, tid);

  float lse_r[4], delta_r[4];
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    lse_r[i] = s < seq ? lse[(size_t)bh * seq + s] : 0.f;
    delta_r[i] = s < seq ? delta[(size_t)bh * seq + s] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (seq + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, k + kv_off, kv_row, k0, seq, tid);
    load_tile<T, D>(v_s, v + kv_off, kv_row, k0, seq, tid);
    __syncthreads();

    float sc[4][4], dp[4][4];
    scores_and_dp<D>(q_s, do_s, k_s, v_s, ty, tx, sc, dp);
    const bool diag = causal && k0 + BK - 1 > q0;
    probs_and_ds(sc, dp, lse_r, delta_r, q0, k0, seq, diag, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(dp[i][j]);
    __syncthreads();

    // dq += ds . k over the tile's keys c.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= seq) continue;
    const size_t at = q_off + (size_t)s * q_row;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[at + tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int batch, int seq,
                   int n_heads, int n_kv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t tiles = sizeof(float) * (size_t)(2 * BQ + 2 * BK) * (D + 1);
  const size_t smem_kv = tiles + sizeof(float) * (2 * BQ * PS + 2 * BQ);
  const size_t smem_q = tiles + sizeof(float) * BQ * PS;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  dim3 grid_kv((seq + BK - 1) / BK, batch * n_kv);
  dkdv<<<grid_kv, kThreads, smem_kv, stream>>>(
      qt, kt, vt, gt, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), seq,
      n_heads, n_kv, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q((seq + BQ - 1) / BQ, batch * n_heads);
  dqk<<<grid_q, kThreads, smem_q, stream>>>(
      qt, kt, vt, gt, lt, dt, static_cast<T*>(dq), seq, n_heads, n_kv,
      causal, scale);
  return cudaGetLastError();
}

// The one head size built, as for the forward kernel.
constexpr int kHeadDim = 128;

}  // namespace
}  // namespace rtt

// C entry point bound with ctypes: both passes of one backward call.
// Returns the first launch's failing cudaError_t, or 0.
extern "C" int rtt_flash_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, int batch, int seq,
                             int n_heads, int n_kv, int head_dim, int causal,
                             float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim != rtt::kHeadDim) return cudaErrorInvalidValue;
  if (dtype == rtt::kFloat32)
    return rtt::launch<float, rtt::kHeadDim>(q, k, v, dout, lse, delta, dq,
                                             dk, dv, batch, seq, n_heads,
                                             n_kv, causal, scale, s);
  if (dtype == rtt::kBFloat16)
    return rtt::launch<__nv_bfloat16, rtt::kHeadDim>(
        q, k, v, dout, lse, delta, dq, dk, dv, batch, seq, n_heads, n_kv,
        causal, scale, s);
  return cudaErrorInvalidValue;
}
