// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of causal or
// full attention, recomputing the probabilities from the forward's saved
// per-row logsumexp.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/flash_attention.py:187
// (_bwd_kernel, pallas_call at :408). Same arithmetic, not the same
// blocking:
//
// - q arrives pre-scaled and rounded to the storage dtype (the wrapper does
//   it, as _flash_bwd does), so s = qs . k^T matches the forward's scores
//   and dk = ds^T . qs needs no extra scale; dq = (ds . k) * scale in fp32,
//   then cast.
// - delta = rowsum(dO * O) in fp32 [B * H, S], computed here by
//   flash_bwd_preprocess_kernel (the reference computes it outside its
//   kernel, as XLA ops).
// - p = exp(s - lse) under the forward's finite -1e9 mask and 0 on query
//   rows past S; p is rounded to dO's dtype before p^T . dO, and ds =
//   p * (dp - delta) to the q/k dtype before ds . k and ds^T . qs. Every
//   product accumulates in fp32.
// - GQA: query head h reads KV head h / n_rep by index. The reference writes
//   dk and dv per query head, rounds them to the storage dtype and sums each
//   group afterwards; here one block sums the group's n_rep heads in fp32
//   registers and rounds once, writing [B, S, Hkv, D] directly.
// - Reads the model's [B, S, H, D] layout by stride (each row is D
//   contiguous elements), so no transposed copies are made; S may be any
//   length, the ragged last tile being masked (keys) and zeroed (rows).
//
// What bounds it on the H100: operations. The backward does five S x S x D
// products per head, 10 * B * H * D * S(S+1)/2 flops causal, against
// O(S * D * H) bytes. Every kernel is built for head_dim D = 64 and 128
// from one template. One rtt_flash_bwd call launches three kernels:
//
// bf16, one fused pass on the tensor cores (FA2/FA3 design):
//   flash_bwd_preprocess_kernel: delta, and zeroes an fp32 dq accumulator
//     [B, S, H, D] that the wrapper allocates.
//   flash_bwd_main_kernel: one block of two warpgroups per (b, KV head,
//     128-key tile), 64 keys each; K and V stay in shared memory while the
//     block walks the group's query heads and, causally, the 64-row query
//     tiles from the diagonal on, q, dO, lse and delta arriving through a
//     two-stage cp.async ring. Per tile pair: s^T = k . q^T and
//     dp^T = v . dO^T (wgmma from shared memory), p^T and ds^T on the
//     fragments, dv += p^T . dO and dk += ds^T . q (p^T and ds^T as bf16
//     register operands, dO and q read MN-major), then ds^T to shared
//     memory and dq = ds . k, added into the accumulator with fp32
//     atomics: 16-byte vector reductions (red.global.add.v4.f32), a
//     quarter of the scalar ones' count. At D = 128 each warpgroup takes
//     one 64-column half of D over all 128 keys; at D = 64 (one half) each
//     takes its own 64 keys, so both add into every dq element. Five
//     products per pair, none recomputed. dk and dv (m64nDk16) stay in
//     fp32 registers over the whole group and are rounded once.
//   flash_bwd_convert_kernel: dq = (accumulator * scale) cast to bf16.
//   The atomics add traffic the bound does not count: the accumulator is
//   zeroed, added into once per (query tile, key tile) pair (S / 128
//   times per element, mostly in L2), then read once. They also add in
//   any order, so bf16 dq is not bit-reproducible from run to run (within
//   fp32 rounding of the sum); dk and dv are.
//   Not yet done: TMA and warp specialisation, a bulk reduce-add of dq
//   from shared memory (cp.reduce.async.bulk), a persistent grid
//   (ROADMAP.md, Queue 2).
//
// fp32, for fp32 callers only (neither main path launches it; it shares
// no tile code with the bf16 kernels and proves nothing about them), two
// deterministic passes with scalar FMAs, as wgmma takes no fp32 input and
// TF32 would change the answer: the preprocess kernel for delta, then
//   flash_bwd_dkdv_kernel: one block of 256 threads per (b * Hkv, 64-key
//     tile) walking the group's query heads and the 64-row q tiles from
//     the diagonal on, dk and dv in registers;
//   flash_bwd_dq_kernel: one block per (b * h, 64-row q tile), recomputing
//     s and dp over the kv tiles up to the diagonal.

#include <cstddef>

#include "common.cuh"
#include "wgmma_tile.cuh"


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

// ---------------------------------------------- delta and dq, both dtypes
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}

// delta[b * H + h, s] = sum_d dO * O in fp32, D / 4 lanes per (b, s, h)
// row (a warp at D = 128, half a warp at D = 64), four elements a lane;
// zeroes that row of the dq accumulator when one is given.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_preprocess_kernel(
    const T* __restrict__ out,   // [B, S, H, D]
    const T* __restrict__ dout,  // [B, S, H, D]
    float* __restrict__ delta,   // [B * H, S]
    float* __restrict__ dq_acc,  // [B, S, H, D] or null
    int rows, int seq, int n_heads) {
  constexpr int kLanes = D / 4;  // lanes per row
  const int row = blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  // Every lane of a warp takes part in the shuffles: a row past the end
  // sums zeros and stores nothing.
  const bool in = row < rows;
  const size_t at = (size_t)(in ? row : 0) * D + lane * 4;
  float o[4], g[4];
  load4(out + at, o);
  load4(dout + at, g);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc = fmaf(g[e], o[e], acc);
  acc = group_sum<kLanes>(acc);
  if (!in) return;
  if (lane == 0) {
    const int h = row % n_heads, bs = row / n_heads;
    const int b = bs / seq, s = bs % seq;
    delta[((size_t)b * n_heads + h) * seq + s] = acc;
  }
  if (dq_acc != nullptr)
    *reinterpret_cast<float4*>(dq_acc + at) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq = (accumulator * scale) rounded to bf16, four elements a thread.
__global__ void __launch_bounds__(256) flash_bwd_convert_kernel(
    const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
    size_t n4, float scale) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[i];
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dq) + 2 * i;
  o[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
  o[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
}

template <typename T, int D>
cudaError_t launch_preprocess(const void* out, const void* dout, void* delta,
                              void* dq_acc, int batch, int seq, int n_heads,
                              cudaStream_t stream) {
  const int rows = batch * seq * n_heads;
  constexpr int kRows = 256 / (D / 4);  // rows per block
  flash_bwd_preprocess_kernel<T, D><<<(rows + kRows - 1) / kRows, 256, 0,
                                      stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), static_cast<float*>(dq_acc), rows, seq,
      n_heads);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, tensor cores
namespace wg {

constexpr int kThreads = 256;  // two warpgroups
constexpr int TK = 128;        // keys per block, 64 per warpgroup
constexpr int TQ = 64;         // query rows per step
template <int D>
constexpr int kKTile = tile::tile_bytes(TK, D);  // a [128, D] bf16 tile
template <int D>
constexpr int kQTile = tile::tile_bytes(TQ, D);  // a [64, D] bf16 tile
constexpr int kDsBytes = TK * TQ * 2;  // ds^T, [128 keys, 64 rows]
// k, v; two stages of (q, dO); ds^T; two stages of (lse, delta); slack.
template <int D>
constexpr int kSmem = 2 * kKTile<D> + 4 * kQTile<D> + kDsBytes +
                      2 * 2 * TQ * (int)sizeof(float) + tile::kAtomBytes;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;     // [B, S, H, D], pre-scaled
  const __nv_bfloat16* k;     // [B, S, Hkv, D]
  const __nv_bfloat16* v;     // [B, S, Hkv, D]
  const __nv_bfloat16* dout;  // [B, S, H, D]
  const float* lse;           // [B * H, S]
  const float* delta;         // [B * H, S]
  float* dq_acc;              // [B, S, H, D], zeroed
  __nv_bfloat16* dk;          // [B, S, Hkv, D]
  __nv_bfloat16* dv;          // [B, S, Hkv, D]
  int seq, n_heads, n_kv, causal;
};

// Loads step `it` of a block's walk (query head r, query tile qt) into
// ring stage it % 2: q and dO tiles, lse and delta rows.
template <int D>
__device__ __forceinline__ void load_step(const Args& a, uint8_t* q_s,
                                          uint8_t* do_s, float* rows_s,
                                          int b, int h, int q0, int stage,
                                          int tid) {
  const size_t q_row = (size_t)a.n_heads * D;
  const size_t off = (size_t)b * a.seq * q_row + (size_t)h * D;
  tile::load_tile<TQ, D, kThreads>(q_s + stage * kQTile<D>, a.q + off,
                                   q_row, q0, a.seq, tid);
  tile::load_tile<TQ, D, kThreads>(do_s + stage * kQTile<D>, a.dout + off,
                                   q_row, q0, a.seq, tid);
  const size_t bh = ((size_t)b * a.n_heads + h) * a.seq;
  float* rs = rows_s + stage * 2 * TQ;
  tile::load_row_f32(rs, a.lse + bh, q0, a.seq, TQ, tid);
  tile::load_row_f32(rs + TQ, a.delta + bh, q0, a.seq, TQ, tid - TQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_main_kernel(const Args a) {
  using namespace tile;
  constexpr int kQT = kQTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_smem(smem_raw);
  uint8_t* v_s = k_s + kKTile<D>;
  uint8_t* q_s = v_s + kKTile<D>;  // stage i at q_s + i * kQT
  uint8_t* do_s = q_s + 2 * kQT;   // stage i at do_s + i * kQT
  uint8_t* ds_s = do_s + 2 * kQT;
  float* rows_s = reinterpret_cast<float*>(ds_s + kDsBytes);  // lse, delta

  const int seq = a.seq, n_heads = a.n_heads, n_kv = a.n_kv;
  const int b = blockIdx.x / n_kv, hk = blockIdx.x % n_kv;
  const int k0 = blockIdx.y * TK;  // the first key tiles see the most rows
  const int n_rep = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int frag_row = 16 * ((tid >> 5) & 3) + (lane >> 2);  // and + 8
  const int col = 2 * (lane & 3);  // accumulator columns 8 j + col + {0, 1}
  const int krow = 64 * wg + frag_row;  // this thread's keys, k0 + krow (+ 8)

  const size_t q_row = (size_t)n_heads * D;
  const size_t kv_row = (size_t)n_kv * D;
  const size_t kv_off = (size_t)b * seq * kv_row + (size_t)hk * D;
  tile::load_tile<TK, D, kThreads>(k_s, a.k + kv_off, kv_row, k0, seq, tid);
  tile::load_tile<TK, D, kThreads>(v_s, a.v + kv_off, kv_row, k0, seq, tid);

  const int n_qt = (seq + TQ - 1) / TQ;
  // Causal: query tiles wholly before this key tile see none of it.
  const int qt0 = a.causal ? k0 / TQ : 0;
  const int per_head = n_qt - qt0;
  const int n_it = n_rep * per_head;
  load_step<D>(a, q_s, do_s, rows_s, b, hk * n_rep, qt0 * TQ, 0, tid);
  cp_async_commit();

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int h = hk * n_rep + it / per_head;
    const int q0 = (qt0 + it % per_head) * TQ;
    const uint8_t* qs = q_s + (it & 1) * kQT;
    const uint8_t* dos = do_s + (it & 1) * kQT;
    const float* lse_s = rows_s + (it & 1) * 2 * TQ;
    const float* delta_s = lse_s + TQ;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // step it has landed; step it - 1 is no longer read
    if (it + 1 < n_it) {  // the next step loads while this one is used
      load_step<D>(a, q_s, do_s, rows_s, b, hk * n_rep + (it + 1) / per_head,
                   (qt0 + (it + 1) % per_head) * TQ, (it + 1) & 1, tid);
      cp_async_commit();
    }

    // s^T = k . q^T and dp^T = v . dO^T: [64 keys, 64 rows] per warpgroup.
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(st, desc_k_major(k_s, TK, 64 * wg, kk),
                               desc_k_major(qs, TQ, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(dpt, desc_k_major(v_s, TK, 64 * wg, kk),
                               desc_k_major(dos, TQ, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta) on the fragments:
    // element 4 j + 2 r + e is key k0 + krow + 8 r, row q0 + 8 j + col + e.
    const bool edge = (a.causal && k0 + TK - 1 > q0) || k0 + TK > seq ||
                      q0 + TQ > seq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + col + e;
        const float lse_l = lse_s[qc] * kLog2e;
        const float dl = delta_s[qc];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float sv = st[i];
          if (edge) {
            const int key = k0 + krow + 8 * r;
            if (key >= seq || (a.causal && key > q0 + qc)) sv = kMask;
          }
          float p = exp2f(fmaf(sv, kLog2e, -lse_l));
          if (edge && q0 + qc >= seq) p = 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - dl);
        }
      }
    uint32_t pa[4][4], dsa[4][4];  // bf16 A operands, 4 steps over 64 rows
    acc_to_a<64>(st, pa);
    acc_to_a<64>(dpt, dsa);
    // ds^T into shared memory ([128 keys, 64 rows], swizzled) for dq.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kr = krow + 8 * r;
        *reinterpret_cast<uint32_t*>(ds_s + chunk_offset(TK, kr, j) +
                                     2 * col) = dsa[j >> 1][2 * (j & 1) + r];
      }

    // dv += p^T . dO and dk += ds^T . q, dO and q read MN-major.
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
      wgmma_rs<D, 1>(dv, pa[kk], desc_mn_major(dos, TQ, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
      wgmma_rs<D, 1>(dk, dsa[kk], desc_mn_major(qs, TQ, 0, kk), 1);
    wgmma_commit();
    fence_proxy_async();
    __syncthreads();  // ds^T of both warpgroups is in shared memory

    // D = 128: dq[:, 64 wg ..] = ds . k[:, 64 wg ..] over the 128 keys.
    // D = 64: dq = ds[:, keys of wg] . k[keys of wg, :], the partial sum
    // over this warpgroup's 64 keys. ds^T read MN-major as A (M = rows),
    // k's column half MN-major as B.
    constexpr bool kSplitD = D == 128;
    constexpr int kSteps = kSplitD ? TK / 16 : TK / 32;
    const int col_half = kSplitD ? wg : 0;
    const int kk0 = kSplitD ? 0 : kSteps * wg;
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
      wgmma_m64n64k16_ss<1, 1>(dq, desc_mn_major(ds_s, TK, 0, kk0 + i),
                               desc_mn_major(k_s, TK, col_half, kk0 + i), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dv);
    fence_regs(dk);
    fence_words(pa);
    fence_words(dsa);

    // Add dq into the accumulator, 16 bytes per reduction: the two lanes of
    // a pair swap halves so that the even lane holds 4 consecutive columns
    // of row frag_row and the odd lane 4 of row frag_row + 8.
    const bool odd = lane & 1;
    const int s = q0 + frag_row + (odd ? 8 : 0);
    float* dqr = a.dq_acc + ((size_t)b * seq + s) * q_row + (size_t)h * D +
                 64 * col_half + col - (odd ? 2 : 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* lo = dq + 4 * j;  // row frag_row, then frag_row + 8
      const float x = __shfl_xor_sync(0xffffffffu, odd ? lo[0] : lo[2], 1);
      const float y = __shfl_xor_sync(0xffffffffu, odd ? lo[1] : lo[3], 1);
      if (s < seq) {
        if (odd)
          red_add_v4(dqr + 8 * j, x, y, lo[2], lo[3]);
        else
          red_add_v4(dqr + 8 * j, lo[0], lo[1], x, y);
      }
    }
  }

  // dk and dv, summed over the group in fp32, rounded once.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = k0 + krow + 8 * r;
    if (s >= seq) continue;
    const size_t at = kv_off + (size_t)s * kv_row + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + at + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + at + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int batch, float scale, __nv_bfloat16* dq,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_main_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<D>);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * a.n_kv, (a.seq + TK - 1) / TK);
  kernel<<<grid, kThreads, kSmem<D>, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)batch * a.seq * a.n_heads * D / 4;
  flash_bwd_convert_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      a.dq_acc, dq, n4, scale);
  return cudaGetLastError();
}

}  // namespace wg

// Every kernel of one backward call at one head size (see the note above).
template <int D>
int run(int dtype, const void* q, const void* k, const void* v,
        const void* dout, const void* out, const void* lse, void* delta,
        void* dq_acc, void* dq, void* dk, void* dv, int batch, int seq,
        int n_heads, int n_kv, int causal, float scale, cudaStream_t s) {
  if (dtype == kFloat32) {
    cudaError_t err = launch_preprocess<float, D>(
        out, dout, delta, nullptr, batch, seq, n_heads, s);
    if (err != cudaSuccess) return err;
    return launch<float, D>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                            seq, n_heads, n_kv, causal, scale, s);
  }
  if (dtype == kBFloat16) {
    if (dq_acc == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = launch_preprocess<__nv_bfloat16, D>(
        out, dout, delta, dq_acc, batch, seq, n_heads, s);
    if (err != cudaSuccess) return err;
    const wg::Args a{static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v),
                     static_cast<const __nv_bfloat16*>(dout),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<float*>(dq_acc),
                     static_cast<__nv_bfloat16*>(dk),
                     static_cast<__nv_bfloat16*>(dv),
                     seq, n_heads, n_kv, causal};
    return wg::launch<D>(a, batch, scale, static_cast<__nv_bfloat16*>(dq),
                         s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rtt

// C entry point bound with ctypes: every kernel of one backward call (see
// the note above). `delta` ([B * H, S] fp32) and, for bf16, `dq_acc`
// ([B, S, H, D] fp32) are scratch the wrapper allocates; fp32 passes no
// dq_acc. The dtype picks the route: bf16 always takes the tensor-core
// kernels, fp32 the scalar ones. The head sizes built are 64 and 128; any
// other is refused. Returns the first failing launch's cudaError_t, or 0.
extern "C" int rtt_flash_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* out,
                             const void* lse, void* delta, void* dq_acc,
                             void* dq, void* dk, void* dv, int batch, int seq,
                             int n_heads, int n_kv, int head_dim, int causal,
                             float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return rtt::run<128>(dtype, q, k, v, dout, out, lse, delta, dq_acc, dq,
                         dk, dv, batch, seq, n_heads, n_kv, causal, scale, s);
  if (head_dim == 64)
    return rtt::run<64>(dtype, q, k, v, dout, out, lse, delta, dq_acc, dq,
                        dk, dv, batch, seq, n_heads, n_kv, causal, scale, s);
  return cudaErrorInvalidValue;
}
