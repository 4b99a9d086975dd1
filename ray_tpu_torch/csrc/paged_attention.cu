// Paged decode / speculative-verify attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/paged_attention.py
// (_make_kernel -> _kernel, launched by paged_attention). Same function:
// query token k of slot b attends the key cells at positions
// <= positions[b] + k of the pages its block table lists, with an fp32
// online softmax; table entries of -1 read the dump page 0.
//
// What bounds it on the H100: bytes. A step reads every live K/V page of
// every slot once (2 * pages * Hkv * P * Dh * 2 bytes in bf16) and does
// only 2 * n_rep * K flops per K/V element (4 per byte at 32/8 heads and
// K = 1; 3 per byte at mini's 12/4 heads of 64), far below the ~295 flops
// per byte where the tensor cores would become the limit. So the design
// is about keeping the HBM busy:
//
// - Split the page walk (flash-decoding). The grid is (KV head x row
//   block, slot, split); a split covers `pages_per_split` table entries,
//   chosen by the wrapper from static shapes and the SM count. A split
//   that starts past the slot's last live page returns at once: the
//   combine reads the live splits only, so its weight is exactly 0.
// - Bulk asynchronous copies. With the head-major pool one (page, KV head)
//   tile is one contiguous run (P x Dh x 2 bytes in bf16), so thread 0
//   copies K and V with cp.async.bulk copies that complete on an mbarrier.
//   A ring stage holds at most 64 key cells: for P <= 64 the
//   floor(64 / P) consecutive table entries of whole pages (one bulk copy
//   of a whole tile each for K and for V; P = 48 fills 48 cells), for
//   P > 64 a 64-cell part of one page (a page spans ceil(P / 64) stages,
//   each one bulk copy at an offset of 64 rows inside the tile). Every
//   copy and every offset is a multiple of 16 bytes at Dh in {64, 128}
//   for any P, in bf16 and in fp32 (a row is 128 bytes at least). A ring
//   of up to kMaxStages stages is in flight per block; the mbarrier
//   expects each stage's own bytes. The tiles stay in the input dtype in
//   shared memory. A stage's cells past its copied cells (the tail of a
//   slot's last stage, or every stage shorter than 64 cells) are masked
//   in q.k and skipped in p.v (stale shared memory is never read into a
//   sum).
// - CUDA-core products from the tiles. Warp w owns cells 16w..16w+15 of
//   every stage. For q.k, L = 2R lanes share a cell, each holding a slice of
//   q for all R rows in registers; a reduce-scatter across the L lanes
//   leaves each lane whole scores (4 flops per byte need no tensor cores,
//   and the unswizzled bulk-copied tile would make mma fragment loads
//   conflict 8 ways). For p.v each lane owns Dh / 32 head columns of all
//   rows (4 at 128, 2 at 64: one 8- or 4-byte read per cell, 32 lanes on
//   one contiguous row, conflict-free).
//   One __syncthreads per stage: the warps' row maxima meet in shared
//   memory, so the running max (and the point where p is rounded to v's
//   dtype) is the split's, stage by stage, as in
//   paged_attention_split_reference (which steps through the same
//   stages).
// - One launch. A split with siblings writes its unnormalised fp32 O, m
//   and l to a workspace; the last block of a (slot, KV head, row block)
//   to take a ticket combines them: O = sum_s exp(m_s - M) O_s /
//   sum_s exp(m_s - M) l_s, M = max_s m_s, and resets the ticket. A slot
//   whose pages fit one split writes its output directly. Thread t
//   finishes head column t % Dh of rows t / Dh, t / Dh + 128 / Dh, ...
//   (all R rows at 128, every other row at 64); padded rows (n_rep * K
//   below R) are computed but never written, and weigh nothing in the
//   combine.
//
// Built for head sizes 64 and 128 (mini's and llama3_8b's) from this one
// template, and for any page size (a runtime argument; pages_per_split is
// a multiple of the pages per stage, so a stage never spans two splits).

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace rtt {
namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 64;     // key cells per ring stage: 16 per warp
constexpr int kMaxSub = 16;    // table entries read ahead per batch of copies
constexpr int kMaxStages = 3;  // stages in flight per block

// The stage rule that the wrapper (ops/paged_attention.py, stage_layout)
// shares: whole pages per stage, and stages per page.
__host__ __device__ constexpr int pages_per_stage(int page) {
  return page <= kStage ? kStage / page : 1;
}
__host__ __device__ constexpr int stages_per_page(int page) {
  return (page + kStage - 1) / kStage;
}

// Elements of one ring stage's K (or V) tile at head size D.
template <int D>
__host__ __device__ constexpr int tile_elems() {
  static_assert(D == 64 || D == 128, "head sizes 64 and 128 are built");
  static_assert(kThreads % D == 0 && D % 32 == 0, "thread layout");
  return kStage * D;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// copy that never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    if (++spins == (1u << 22)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One contiguous global -> shared copy, counted in bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int U>
struct alignas(sizeof(T) * U) Vec {
  T v[U];
};

// U consecutive elements (one vector load) as fp32.
template <typename T, int U>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  const Vec<T, U> x = *reinterpret_cast<const Vec<T, U>*>(p);
#pragma unroll
  for (int i = 0; i < U; ++i) f[i] = to_float(x.v[i]);
}

// Shared memory: a region that holds the page ring during the walk, then
// the warps' partial O, then the combine's weights; after it the per-warp
// probabilities, the warps' row maxima (two pages' worth), the warps'
// row sums, the ring's barriers and the ticket flag.
template <typename T, int D, int R>
__host__ __device__ constexpr size_t region_bytes(int stages, int n_split) {
  const size_t ring = (size_t)stages * 2 * tile_elems<D>() * sizeof(T);
  const size_t warps_o = (size_t)kWarps * R * D * sizeof(float);
  const size_t weights = (size_t)n_split * R * sizeof(float);
  const size_t m = ring > warps_o ? ring : warps_o;
  return ((m > weights ? m : weights) + 127) / 128 * 128;
}

template <typename T, int D, int R>
__host__ __device__ constexpr size_t smem_bytes(int stages, int n_split) {
  return region_bytes<T, D, R>(stages, n_split) +
         sizeof(float) * (kWarps * R * 16 + 3 * kWarps * R) +
         sizeof(uint64_t) * kMaxStages + 16;
}

// R query rows per block (n_rep * K rows of one KV head, padded to R):
// 4 at decode and 16 at verify for 32/8 and for 12/4 heads (3 and 12
// live rows at 12/4). D is the head size.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q,           // [B, K, H, Dh]
    const T* __restrict__ k_pool,      // [num_pages, Hkv, P, Dh]
    const T* __restrict__ v_pool,      // [num_pages, Hkv, P, Dh]
    const int* __restrict__ tables,    // [B, max_pages], -1 = unused
    const int* __restrict__ positions, // [B]
    T* __restrict__ out,               // [B, K, H, Dh]
    float* __restrict__ ws_acc,        // [B, groups, n_split, R, Dh]
    float* __restrict__ ws_ml,         // [B, groups, n_split, R, 2]
    int* __restrict__ tickets,         // [B, groups], 0 between calls
    int kq, int n_heads, int n_kv, int page, int max_pages,
    int pages_per_split, int stages, float scale) {
  constexpr int kTile = tile_elems<D>();
  constexpr int L = 2 * R;             // lanes per key cell in q.k
  constexpr int G = 32 / L;            // cells per warp per iteration
  constexpr int E = D / L;             // head elements per lane in q.k
  constexpr int U = (int)(16 / sizeof(T)) < E ? (int)(16 / sizeof(T)) : E;
  constexpr int NL = E / U;            // vector loads per lane per cell
  constexpr int IB = R == 16 ? 2 : 4;  // iterations per reduce-scatter
  constexpr int VPL = IB / 2;          // scores per lane per reduction
  constexpr int NB = R / IB;           // reductions per page (R iterations)
  constexpr int RG = R / VPL;          // lanes holding distinct row groups
  constexpr int LOG2L = R == 4 ? 3 : (R == 8 ? 4 : 5);
  constexpr int C = D / 32;            // head columns per lane in p.v
  constexpr int CT = kThreads / D;     // threads per head column at the end
  constexpr int RT = R / CT;           // rows per thread at the end
  static_assert(R == 4 || R == 8 || R == 16, "row block of 4, 8 or 16");
  static_assert((1 << LOG2L) == L && NB * IB == R && E % U == 0, "shape");

  const int gx = blockIdx.x;  // KV head x row block
  const int n_rb = gridDim.x / n_kv;
  const int g = gx / n_rb;
  const int r_base = (gx % n_rb) * R;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int n_rep = n_heads / n_kv;
  const int r_live = min(R, n_rep * kq - r_base);
  const int pos = positions[b];
  const int lastp = min(max((pos + kq - 1) / page, 0), max_pages - 1);
  const int first = split * pages_per_split;
  if (first > lastp) return;  // empty split: weight 0, the combine skips it
  const int np = pages_per_stage(page);  // table entries per stage
  const int sp = stages_per_page(page);  // stages per table entry
  const int n_entries = min(first + pages_per_split, lastp + 1) - first;
  const int n_steps = (n_entries + np - 1) / np * sp;  // stages walked
  const int n_live = lastp / pages_per_split + 1;
  const int ptile = page * D;  // elements of one (page, KV head) tile

  extern __shared__ __align__(128) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stages][K, V][kStage][D]
  float* pw = reinterpret_cast<float*>(
      smem + region_bytes<T, D, R>(stages, n_split));  // [kWarps][R][16]
  float* wmax = pw + kWarps * R * 16;               // [2][kWarps][R]
  float* lsum = wmax + 2 * kWarps * R;              // [kWarps][R]
  uint64_t* bars = reinterpret_cast<uint64_t*>(lsum + kWarps * R);
  int* last_flag = reinterpret_cast<int*>(bars + kMaxStages);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = lane % L;   // place in the lane group of a cell
  const int cg = lane / L;  // which of the iteration's G cells
  const int* table = tables + (size_t)b * max_pages;

  // Stage t of the split: table entries e0 .. e0 + n_sub - 1 from cell
  // `sub * kStage` of each tile, `cells` key cells in all, the first at
  // key position `key`.
  struct Stage {
    int e0, n_sub, sub, cells, key;
  };
  auto stage = [&](int t) {
    Stage st;
    const int pg = t / sp;
    st.e0 = first + pg * np;
    st.n_sub = min(np, n_entries - pg * np);
    st.sub = t % sp;
    st.cells =
        sp == 1 ? st.n_sub * page : min(kStage, page - st.sub * kStage);
    st.key = st.e0 * page + st.sub * kStage;
    return st;
  };
  // Stage t into ring slot t % stages: one bulk copy per table entry for
  // K and for V (of a whole tile, or of its part for pages over 64 cells).
  auto issue = [&](int t) {
    const Stage st = stage(t);
    T* dst = ring + (size_t)(t % stages) * 2 * kTile;
    uint64_t* bar = &bars[t % stages];
    const int rows = sp == 1 ? page : st.cells;  // cells per copy
    const uint32_t bytes = rows * D * sizeof(T);
    const size_t off = (size_t)st.sub * kStage * D;
    mbar_expect_tx(bar, 2 * st.n_sub * bytes);
    for (int s0 = 0; s0 < st.n_sub; s0 += kMaxSub) {
      int pages[kMaxSub];
#pragma unroll
      for (int s = 0; s < kMaxSub; ++s)
        pages[s] = s0 + s < st.n_sub ? max(table[st.e0 + s0 + s], 0) : 0;
#pragma unroll
      for (int s = 0; s < kMaxSub; ++s) {
        if (s0 + s < st.n_sub) {
          const size_t src = ((size_t)pages[s] * n_kv + g) * ptile + off;
          bulk_copy(dst + (s0 + s) * rows * D, k_pool + src, bytes, bar);
          bulk_copy(dst + kTile + (s0 + s) * rows * D, v_pool + src, bytes,
                    bar);
        }
      }
    }
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(stages, n_steps); ++t) issue(t);
  }

  // This lane's slice of q for the block's R rows: head elements
  // (j + L * u) * U .. + U - 1 for u < NL (rows past r_live are 0).
  float qr[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r_base + r;
    const T* qp = q + ((size_t)(b * kq + row % kq) * n_heads + g * n_rep +
                       row / kq) * D;
#pragma unroll
    for (int u = 0; u < NL; ++u)
#pragma unroll
      for (int e = 0; e < U; ++e)
        qr[r][u * U + e] =
            r < r_live ? to_float(qp[(j + L * u) * U + e]) : 0.f;
  }
  // After each reduce-scatter this lane holds the scores of rows
  // r0 .. r0 + VPL - 1 of one cell (the same rows in every reduction).
  const int i_local = (j * VPL) / R;
  const int r0 = (j * VPL) % R;
  int qpos[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) qpos[v] = pos + (r_base + r0 + v) % kq;

  float m_run[R];      // running max of every row (same in every lane)
  float acc[R][C];     // this warp's p.v, columns C * lane .. + C - 1
  float m_own[VPL];    // running max of this lane's score rows
  float l_own[VPL];    // this lane's share of their row sums
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kMInit;
#pragma unroll
    for (int d = 0; d < C; ++d) acc[r][d] = 0.f;
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    m_own[v] = kMInit;
    l_own[v] = 0.f;
  }
  float* pwarp = pw + warp * R * 16;
  __syncthreads();  // barriers initialised

  for (int t = 0; t < n_steps; ++t) {
    mbar_wait(&bars[t % stages], (t / stages) & 1);
    const T* kt = ring + (size_t)(t % stages) * 2 * kTile + warp * 16 * D;
    const T* vt = kt + kTile;
    const Stage st = stage(t);
    const int key0 = st.key + warp * 16;
    // Cells of this warp that were copied (a stage may hold fewer than
    // 64 cells; the rest lie past every query position or are masked).
    const int n_cells = min(16, max(0, st.cells - warp * 16));

    // Scores of this warp's 16 cells, scaled after the product, masked
    // past each row's query position and past the copied cells.
    float sc[NB][VPL];
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      float a[IB * R];
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const T* krow = kt + ((bi * IB + i) * G + cg) * D;
        float kv[E];
#pragma unroll
        for (int u = 0; u < NL; ++u)
          load_vec<T, U>(krow + (j + L * u) * U, kv + u * U);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qr[r][e], kv[e], s);
          a[i * R + r] = s;
        }
      }
      // Reduce-scatter over the L lanes of the cell: each step halves
      // the values a lane holds; lane j keeps block j of VPL sums.
#pragma unroll
      for (int stp = 0; stp < LOG2L; ++stp) {
        const int o = L >> (stp + 1);
        const int half = (IB * R) >> (stp + 1);
        const bool up = lane & o;
#pragma unroll
        for (int k = 0; k < IB * R / 2; ++k) {
          if (k < half) {
            const float send = up ? a[k] : a[k + half];
            const float keep = up ? a[k + half] : a[k];
            a[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
      }
      const int cell = (bi * IB + i_local) * G + cg;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        sc[bi][v] = (key0 + cell > qpos[v] || cell >= n_cells)
                        ? kMask : a[v] * scale;
    }

    // Row maxima over this warp's cells, then over the block.
    float* wm = wmax + (t & 1) * kWarps * R;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      float mx = sc[0][v];
#pragma unroll
      for (int bi = 1; bi < NB; ++bi) mx = fmaxf(mx, sc[bi][v]);
#pragma unroll
      for (int o = RG; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane < RG) wm[warp * R + r0 + v] = mx;
    }
    __syncthreads();  // maxima visible; every warp is done with page t - 1
    if (tid == 0 && t >= 1 && t - 1 + stages < n_steps)
      issue(t - 1 + stages);  // into stage t - 1's ring slot

#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int r = r0 + v;
      const float pm = fmaxf(fmaxf(wm[r], wm[R + r]),
                             fmaxf(wm[2 * R + r], wm[3 * R + r]));
      const float mn = fmaxf(m_own[v], pm);
      l_own[v] *= expf(m_own[v] - mn);
      m_own[v] = mn;
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        const float p = expf(sc[bi][v] - mn);
        l_own[v] += p;
        // p in v's dtype for the p.v product
        pwarp[r * 16 + (bi * IB + i_local) * G + cg] = round_to<T>(p);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pm = fmaxf(fmaxf(wm[r], wm[R + r]),
                             fmaxf(wm[2 * R + r], wm[3 * R + r]));
      const float mn = fmaxf(m_run[r], pm);
      const float alpha = expf(m_run[r] - mn);
      m_run[r] = mn;
#pragma unroll
      for (int d = 0; d < C; ++d) acc[r][d] *= alpha;
    }
    __syncwarp();  // the warp's p visible to all its lanes

#pragma unroll 4
    for (int c = 0; c < n_cells; ++c) {
      float vv[C];
      load_vec<T, C>(vt + c * D + C * lane, vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pwarp[r * 16 + c];
#pragma unroll
        for (int d = 0; d < C; ++d) acc[r][d] = fmaf(p, vv[d], acc[r][d]);
      }
    }
  }

  // Row sums over the lanes and warps; O over the warps.
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
#pragma unroll
    for (int o = RG; o < 32; o <<= 1)
      l_own[v] += __shfl_xor_sync(0xffffffffu, l_own[v], o);
    if (lane < RG) lsum[warp * R + r0 + v] = l_own[v];
  }
  __syncthreads();  // the ring is free: every issued page was consumed
  float* warp_o = reinterpret_cast<float*>(smem);  // [kWarps][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    Vec<float, C> o;
#pragma unroll
    for (int d = 0; d < C; ++d) o.v[d] = acc[r][d];
    *reinterpret_cast<Vec<float, C>*>(warp_o + (warp * R + r) * D +
                                      C * lane) = o;
  }
  __syncthreads();
  // This thread finishes column d of rows rh, rh + CT, ... (row i * CT +
  // rh is its i-th).
  const int d = tid % D;
  const int rh = tid / D;
  auto l_row = [&](int r) {  // row r's sum over the warps
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += lsum[w * R + r];
    return l;
  };
  float o_sum[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = i * CT + rh;
    o_sum[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o_sum[i] += warp_o[(w * R + r) * D + d];
  }
  auto out_at = [&](int r) {
    const int row = r_base + r;
    return out + ((size_t)(b * kq + row % kq) * n_heads + g * n_rep +
                  row / kq) * D + d;
  };
  if (n_live == 1) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = i * CT + rh;
      if (r < r_live) {
        const float l = l_row(r);
        *out_at(r) = from_float<T>(o_sum[i] / (l == 0.f ? 1.f : l));
      }
    }
    return;
  }

  // Partial of this split; the last of the live splits to finish combines.
  const size_t wi = (size_t)b * gridDim.x + gx;
  const size_t part = (wi * n_split + split) * R;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    ws_acc[(part + i * CT + rh) * D + d] = o_sum[i];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (tid == r) {
      ws_ml[(part + r) * 2] = m_run[r];
      ws_ml[(part + r) * 2 + 1] = l_row(r);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_flag = atomicAdd(tickets + wi, 1) == n_live - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();

  float* weights = reinterpret_cast<float*>(smem);  // [n_live][R]
  const float* ml = ws_ml + wi * n_split * R * 2;
  for (int r = warp; r < r_live; r += kWarps) {
    float mx = kMInit;
    for (int s = lane; s < n_live; s += 32)
      mx = fmaxf(mx, __ldcg(ml + (s * R + r) * 2));
    mx = group_max<32>(mx);
    float den = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const float w = expf(__ldcg(ml + (s * R + r) * 2) - mx);
      weights[s * R + r] = w;
      den = fmaf(w, __ldcg(ml + (s * R + r) * 2 + 1), den);
    }
    den = group_sum<32>(den);
    if (lane == 0) lsum[r] = den;
  }
  __syncthreads();
  // All RT rows of a split at once: RT independent loads in flight (the
  // weights of padded rows are never set, and those rows never written).
  const float* parts = ws_acc + wi * n_split * R * D + d;
#pragma unroll
  for (int i = 0; i < RT; ++i) o_sum[i] = 0.f;
#pragma unroll 2
  for (int s = 0; s < n_live; ++s)
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = i * CT + rh;
      o_sum[i] = fmaf(weights[s * R + r], __ldcg(parts + (s * R + r) * D),
                      o_sum[i]);
    }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = i * CT + rh;
    if (r < r_live)
      *out_at(r) = from_float<T>(o_sum[i] /
                                 (lsum[r] == 0.f ? 1.f : lsum[r]));
  }
  if (tid == 0) tickets[wi] = 0;  // ready for the next call
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* positions, void* out,
                   void* ws_acc, void* ws_ml, void* tickets, int batch,
                   int kq, int n_heads, int n_kv, int page, int max_pages,
                   int pages_per_split, float scale, cudaStream_t stream) {
  const int n_rb = ((n_heads / n_kv) * kq + R - 1) / R;
  const int n_split = (max_pages + pages_per_split - 1) / pages_per_split;
  // One ring slot when a split is one stage; otherwise at least two, so
  // that the refill of stage t - 1's slot never waits on stage t itself.
  const int steps = pages_per_split / pages_per_stage(page) *
                    stages_per_page(page);
  const int stages = steps < kMaxStages ? steps : kMaxStages;
  const size_t smem = smem_bytes<T, D, R>(stages, n_split);
  auto kernel = paged_attention_kernel<T, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_kv * n_rb, batch, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
      static_cast<int*>(tickets), kq, n_heads, n_kv, page, max_pages,
      pages_per_split, stages, scale);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k_pool, *v_pool, *tables, *positions;
  void *out, *ws_acc, *ws_ml, *tickets;
  int batch, kq, n_heads, n_kv, page, max_pages, pages_per_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t dispatch(int row_block, const Args& a) {
  auto go = [&](auto kernel_launch) {
    return kernel_launch(a.q, a.k_pool, a.v_pool, a.tables, a.positions,
                         a.out, a.ws_acc, a.ws_ml, a.tickets, a.batch, a.kq,
                         a.n_heads, a.n_kv, a.page, a.max_pages,
                         a.pages_per_split, a.scale, a.stream);
  };
  switch (row_block) {
    case 4:
      return go(launch<T, D, 4>);
    case 8:
      return go(launch<T, D, 8>);
    case 16:
      return go(launch<T, D, 16>);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, int row_block, const Args& a) {
  switch (head_dim) {
    case 64:
      return dispatch<T, 64>(row_block, a);
    case 128:
      return dispatch<T, 128>(row_block, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rtt

// C entry point bound with ctypes. Returns the launch's cudaError_t.
// row_block and pages_per_split come from the wrapper
// (ray_tpu_torch/ops/paged_attention.py), which sizes the workspace
// (ws_acc, ws_ml: fp32; tickets: int32 zeros) from the same numbers.
// head_dim must be 64 or 128, page_size at least 1, and pages_per_split
// a multiple of pages_per_stage(page_size).
extern "C" int rtt_paged_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, void* ws_acc,
    void* ws_ml, void* tickets, int batch, int kq, int n_heads, int n_kv,
    int head_dim, int page_size, int max_pages, int row_block,
    int pages_per_split, float scale, void* stream) {
  if (page_size < 1 || pages_per_split < 1 ||
      pages_per_split % rtt::pages_per_stage(page_size))
    return cudaErrorInvalidValue;
  const rtt::Args a{q, k_pool, v_pool, tables, positions, out, ws_acc,
                    ws_ml, tickets, batch, kq, n_heads, n_kv, page_size,
                    max_pages, pages_per_split, scale,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kFloat32)
    return rtt::dispatch_head_dim<float>(head_dim, row_block, a);
  if (dtype == rtt::kBFloat16)
    return rtt::dispatch_head_dim<__nv_bfloat16>(head_dim, row_block, a);
  return cudaErrorInvalidValue;
}
