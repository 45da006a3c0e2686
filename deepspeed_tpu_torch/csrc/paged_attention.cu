// Paged decode attention for NVIDIA Hopper (sm_90a), with a plain C entry
// point for ctypes (built by deepspeed_tpu_torch/ops/op_builder.py).
//
// Replaces the TPU kernels in deepspeed_tpu/ops/transformer/paged_attention.py:
// `_decode_kernel_stream` (:76, the default `stream=True` path) and
// `_decode_kernel` (:38, `stream=False`). Both compute the same function;
// `stream` only chose a TPU memory layout, so this one kernel serves both.
//
// What it computes. One query token per row against a blocked KV pool:
//   q (B, nh, hd), k_pool / v_pool (kvh, NB, BS, hd) kv-head-major,
//   tables (B, MAXB) int32 pool block ids, lens (B,) int32 = position + 1.
// Query heads [h*g, h*g + g) share KV head h (g = nh / kvh). An fp32 online
// softmax runs over the keys at positions < lens[b], which lie in the first
// ceil(lens[b] / BS) table blocks. The output (B, nh, hd) is in q's dtype; a
// row with lens == 0 gives zeros (the TPU kernel's `l_safe`, :156).
//
// What bounds it on this card: bytes. Each (row, kv head) reads K and V of
// its active keys once, 2 * len * hd elements, and does 4 * g * hd flops per
// key: g flops per byte in bf16, below the ~20 flops per byte at which the
// H100's fp32 units, and not its 3.35 TB/s memory, would be the limit. The
// rows of a prefill chunk read the same keys: sharing each tile among 16
// rows multiplies the flops a byte by 16, which the tensor cores take.
//
// What the design does about it (flash-decoding, merged in a cluster;
// prefill rows of one sequence share their tiles):
// - Partitions. A row's table slots are dealt round-robin to P partitions
//   (slot j to partition j % P). P comes from the caller
//   (ops/transformer/paged_attention.py `plan`: min(8, MAXB, ceil(MAXB * BS
//   / 256)), a function of the tensor shapes only): the launch shape is
//   known on the host (nothing reads lens there), and a row's arithmetic
//   does not depend on B. Dealing slots round-robin keeps a long row's
//   partitions within one block of each other and wakes min(P, blocks)
//   partitions of a short row.
// - Two launch shapes, one arithmetic. When the rows leave the card short
//   of CTAs (B * kvh * head chunks < 4 CTAs an SM: decode), grid (B * P,
//   kvh, ceil(g / GMAX)) in clusters of P (<= 8, the portable size): CTA
//   rank p takes partition p of one row, and a partition past the row's
//   last block exits at once. With more rows (prefill chunks, large
//   batches), grid (B, kvh, chunks) with up to R rows a CTA (16 / GMAX in
//   16 bits, 8 / GMAX in fp32): the CTA of row b leads when b % R == 0 or
//   b's table differs from row b - 1's, takes the following rows that hold
//   b's table (up to the next multiple of R), and the other CTAs exit after
//   the comparison. A prefill chunk's rows are one sequence with one table,
//   so a CTA reads each K/V tile once for R rows; rows of different
//   sequences each lead a CTA of one row. The CTA walks all of its rows'
//   partitions, one after the other, through one continuous ring. A
//   partition's state is computed the same way in both shapes (a tile past
//   a row's keys changes no state), and the partitions fold with the same
//   formula in the same order, so a row's output is bitwise the same in
//   either shape, and so in any batch.
// - Many keys in flight. A CTA of four warps streams its keys through a
//   cp.async ring of 2 stages in shared memory (3 or 4 left fewer CTAs an
//   SM and measured slower), a stage holding K and V of TK keys (4096 / hd;
//   at least 32 in 16 bits), each thread copying 16-byte pieces of one key
//   row (the table read once a row); keys past the longest row's are
//   zero-filled, and a tile wholly past them is not walked. 16-byte chunks
//   are XOR-swizzled by row: no bank conflicts.
// - 16 bits: tensor cores. The CTA's (row, query head) slots are the 16
//   rows of mma.sync.m16n8k16 products (a decode CTA's GMAX heads, or a
//   prefill CTA's rows x heads), q's A fragments held in registers. Each
//   tile, warp w computes S = Q K^T for its TK / 4 keys (K by ldmatrix),
//   scaled in fp32 by scale * log2(e); the warps' row maxima meet in shared
//   memory (one max, one rescale a tile and row), P = exp2(S - m) goes to
//   shared memory in 16 bits and the row sums meet there in warp order;
//   then warp w accumulates O[:, hd / 4 w, + hd / 4) = P V over the tile's
//   keys (V by ldmatrix.trans). A thread holds rows g and g + 8 of the
//   fragments, and a partition's (m, l, O) stays in registers.
// - fp32: FMAs. Each warp scores TK / 4 keys, L = hd / 32 lanes a key, 32
//   dims a lane against q in shared memory in fp32, pre-scaled by scale *
//   log2(e); the online softmax (exp2) updates once a tile (one warp max,
//   one sum, one rescale); P.V with the lanes over hd, each key's p
//   broadcast by a shuffle; the four warps' states merge through shared
//   memory in warp order into the partition's state.
// - Merge, in a fixed order. The partitions' states fold in order 0, 1,
//   ... (m = max(m, m_p); l and acc rescaled and summed), dividing once.
//   Split over a cluster, a row with one active partition writes its
//   output at once; otherwise the cluster's other CTAs store their states
//   into rank 0's shared memory through distributed shared memory and rank
//   0 folds them. A CTA of many rows folds each partition as it ends. One
//   launch, no workspace, no atomics: a repeated call is bitwise equal. The
//   cluster barrier has two phases: every CTA arrives at the first at its
//   start and waits for it before storing into rank 0 (rank 0 has
//   started); the second orders the states before rank 0 reads them. A CTA
//   that exits arrives at both first.
//
// Left for later (ROADMAP R4b): fusing the K/V append.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "mma_ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxParts = 8;  // the portable cluster size
// (row, query head) slots a CTA at most: the 16 rows of an mma.sync tile in
// 16 bits, 8 on the fp32 FMA path (its registers hold a state a slot)
constexpr int kSlotsMma = 16, kSlotsFma = 8;
// Finite, as the TPU kernel's NEG_INF: a row that sees no key ends with
// l == 0 and writes zeros instead of NaN.
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N contiguous elements at p (one load of N * sizeof(T) <= 16 bytes), widened.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_float(x.v[e]);
}

// Two 8x8 16-bit matrices, transposed (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The tile shapes. fp32 (FMA): L = hd / 32 lanes score a key, TK = 4096 /
// hd keys a tile. 16 bits (mma.sync): TK = 4096 / hd keys a tile, at least
// 32; each warp scores TK / 4 of them and accumulates P.V for hd / 4 dims.
template <typename T, int HD>
struct Cfg {
  static constexpr bool MMA = sizeof(T) == 2;
  static constexpr int L = HD / 32;                  // FMA: lanes a key in the score pass
  static constexpr int KPW = 32 / L;                 // FMA: keys a warp a tile
  static constexpr int TK = MMA ? (4096 / HD > 32 ? 4096 / HD : 32) : kWarps * KPW;
  static constexpr int EPC = 16 / int(sizeof(T));    // elements a 16-byte chunk
  static constexpr int CPR = HD / EPC;               // chunks a row
  static constexpr int CPL = CPR / L;                // FMA: chunks a lane scores (32 dims)
  static constexpr int VD = HD / 32;                 // FMA: dims a lane accumulates in P.V
  static constexpr int VE = VD < EPC ? VD : EPC;     // FMA: elements a P.V load
  static constexpr int KW = TK / kWarps;             // MMA: keys a warp scores
  static constexpr int NSN = KW / 8;                 // MMA: 8-key tiles of S a warp
  static constexpr int KS = HD / 16;                 // MMA: 16-dim steps of S
  static constexpr int DW = HD / kWarps;             // MMA: dims a warp accumulates
  static constexpr int NO = DW / 8;                  // MMA: 8-dim tiles of O a warp
  static constexpr int QLD = HD + 8, PLD = TK + 8;   // MMA: padded rows of q and P
  static constexpr int TPR = kThreads / TK;          // threads copying one key row
  static constexpr int CPT = CPR / TPR;              // chunks a thread copies of K, of V
  static constexpr int TILE = TK * HD;               // elements of the K (or V) tile
  static constexpr int STAGE = 2 * TILE * int(sizeof(T));
  static constexpr int STAGES = 2;  // 3 or 4 measured slower: fewer CTAs an SM
  static_assert(CPT >= 1 && TK * TPR == kThreads, "tile shape");
  static_assert(MMA ? (NSN >= 1 && KS % 2 == 0 && NO >= 1) : CPL >= 1, "tile shape");
};

// The physical 16-byte chunk of logical chunk c of key row r. fp32: a score
// load phase (8 lanes) reads chunk s + L * i of 8 / L rows, and the XOR puts
// them on 8 distinct bank groups. 16 bits: ldmatrix reads one chunk of 8
// consecutive rows, which c ^ (r & 7) puts on 8 distinct bank groups (hd 32:
// two rows a 128-byte line). P.V on the FMA path reads one row at a time.
template <typename T, int HD>
__device__ __forceinline__ int swz(int r, int c) {
  using C = Cfg<T, HD>;
  if constexpr (C::CPR >= 8) {
    return C::MMA ? c ^ (r & 7) : c ^ ((C::L * r) & 7);
  } else {  // hd 32 in 16 bits: two rows a 128-byte line
    return c ^ ((r >> 1) & (C::CPR - 1));
  }
}

// One step of the partitions' fold: the running (m, l, a) takes in a
// partition's (mp, lp, ap). The same code in every launch shape.
__device__ __forceinline__ void fold(float& m, float& l, float& a, float mp, float lp, float ap) {
  const float mn = fmaxf(m, mp);
  const float c = exp2f(m - mn), cp = exp2f(mp - mn);
  l = fmaf(c, l, __fmul_rn(cp, lp));
  a = fmaf(c, a, __fmul_rn(cp, ap));
  m = mn;
}

// The rows of a CTA (launch shape without clusters): the CTA of row b0
// leads when b0 % R == 0 or b0's table differs from row b0 - 1's, and takes
// the rows after it that hold b0's table, up to the next multiple of R;
// returns how many (0: another CTA has b0).
template <int R>
__device__ __forceinline__ int group_rows(const int32_t* __restrict__ tables, int b0, int batch,
                                          int max_blocks, int* s_diff) {
  if (threadIdx.x < R) s_diff[threadIdx.x] = 0;
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * max_blocks; idx += kThreads) {
    const int r = idx / max_blocks, row = b0 + r;
    if (row > 0 && row < batch && (r > 0 || b0 % R != 0)) {
      const size_t o = (size_t)row * max_blocks + idx % max_blocks;
      if (__ldg(tables + o) != __ldg(tables + o - max_blocks)) s_diff[r] = 1;
    }
  }
  __syncthreads();
  if (b0 % R != 0 && !s_diff[0]) return 0;
  int n = 1;
  while (n < R && b0 + n < batch && (b0 + n) % R != 0 && !s_diff[n]) ++n;
  return n;
}

// The keys of a CTA's partitions: partition p holds table slots p, p + P,
// ...; its key k is offset k % BS of slot p + P * (k / BS). Its keys below
// the longest row's length `len` are a prefix, vkeys(p) long.
struct Keys {
  int parts, bs, len, nblk;
  __device__ __forceinline__ int pos(int p, int k) const {
    const int bi = k / bs;
    return (p + parts * bi) * bs + (k - bi * bs);
  }
  __device__ __forceinline__ int vkeys(int p) const {
    if (p >= nblk) return 0;
    const int nb = (nblk - 1 - p) / parts + 1;  // the partition's blocks
    return p + parts * (nb - 1) == nblk - 1 ? (nb - 1) * bs + len - (nblk - 1) * bs : nb * bs;
  }
};

// The ring's loader: the CTA's tiles in order, partition after partition,
// its cursor (lp, lt) STAGES - 1 tiles ahead of the compute. Thread tid
// copies chunks cu, cu + TPR, ... of K and V row cr of a tile; keys past
// the partition's vkeys are zero-filled.
template <typename T, int HD>
struct Loader {
  using C = Cfg<T, HD>;
  const T* kh;
  const T* vh;
  const int32_t* table;
  Keys ks;
  int lp, lt, p_end, cr, cu;
  __device__ __forceinline__ int ntiles(int p) const { return (ks.vkeys(p) + C::TK - 1) / C::TK; }
  __device__ __forceinline__ void start(int p_first) {
    cr = threadIdx.x / C::TPR, cu = threadIdx.x % C::TPR;
    lp = p_first, lt = 0;
    while (lp < p_end && lt >= ntiles(lp)) ++lp;
  }
  __device__ __forceinline__ void next(T* ring, int st) {
    if (lp >= p_end) return;
    const int k = lt * C::TK + cr;
    const bool ok = k < ks.vkeys(lp);
    size_t src = 0;
    if (ok) {
      const int pos = ks.pos(lp, k);
      src = ((size_t)__ldg(table + pos / ks.bs) * ks.bs + pos % ks.bs) * HD;
    }
    T* const kd = ring + st * 2 * C::TILE + cr * HD;
    T* const vd = kd + C::TILE;
#pragma unroll
    for (int i = 0; i < C::CPT; ++i) {
      const int c = cu + C::TPR * i;
      const int pc = swz<T, HD>(cr, c) * C::EPC;
      cp_async16(kd + pc, ok ? kh + src + c * C::EPC : kh, ok);
      cp_async16(vd + pc, ok ? vh + src + c * C::EPC : vh, ok);
    }
    for (++lt; lp < p_end && lt >= ntiles(lp); lt = 0) ++lp;
  }
};

// Bytes of dynamic shared memory. fp32: the ring, q in fp32, the warps'
// states (acc[NS][HD], then (m, l)[NS]) of the NS = R * GMAX slots, then,
// split over a cluster, one state a partition (in rank 0), else the running
// state's acc and (m, l) after each partition. 16 bits: the ring, q and P
// in 16 bits, the warps' row maxima and sums, then, split over a cluster,
// one state of the GMAX slots a partition (in rank 0).
template <typename T, int HD, int GMAX, int R>
constexpr int smem_bytes(bool split, int parts) {
  using C = Cfg<T, HD>;
  constexpr int NS = R * GMAX;
  if constexpr (C::MMA) {
    return C::STAGES * C::STAGE + 16 * (C::QLD + C::PLD) * 2 + 2 * kWarps * 16 * 4 +
           (split ? parts * NS * (HD + 2) * 4 : 0);
  }
  return C::STAGES * C::STAGE +
         (NS * HD + (kWarps + (split ? parts : 0)) * NS * (HD + 2) +
          (split ? 0 : NS * HD + parts * NS * 2)) *
             4;
}

// Both kernels. `split`: grid (B * P, kvh, chunks) in clusters of P, CTA
// rank p takes partition p of one row (R == 1). Else grid (B, kvh, chunks):
// the CTA of a leading row takes up to R rows that share its table
// (group_rows) and all of their partitions, in order, through one
// continuous ring. Slot i of a CTA is (row i / GMAX of its rows, query head
// g0 + i % GMAX).

// fp32: FMAs, 8 slots at most.
template <typename T, int HD, int GMAX, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_fma_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool, const int32_t* __restrict__ tables,
                        const int32_t* __restrict__ lens, T* __restrict__ out, int batch, int nh,
                        int g, int num_blocks, int block_size, int max_blocks, int parts,
                        bool split, float scale) {
  using C = Cfg<T, HD>;
  constexpr int NS = R * GMAX;
  constexpr int WSZ = NS * (HD + 2);  // a state: acc[NS][HD], then (m, l)[NS]
  static_assert(NS <= kSlotsFma, "slots");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_diff[R];  // row b0 + r's table differs from row b0 + r - 1's
  T* const ring = reinterpret_cast<T*>(smem);
  float* const s_q = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);  // [NS][HD]
  float* const ws = s_q + NS * HD;       // [kWarps][WSZ]: the warps' states
  float* const s_st = ws + kWarps * WSZ;  // split: [parts][WSZ]; else acc[NS][HD], (m, l)[parts][NS]

  const int rank = split && parts > 1 ? int(cluster_ctarank()) : 0;
  const int b0 = split ? blockIdx.x / parts : blockIdx.x;
  int nrows = 1;
  if constexpr (R > 1) {
    nrows = group_rows<R>(tables, b0, batch, max_blocks, s_diff);
    if (nrows == 0) return;
  }
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * GMAX;  // first query head of this CTA's chunk
  const int ng = min(GMAX, g - g0);
  // slot i holds a (row, query head) of this CTA: uniform across the CTA
  auto slot_ok = [&](int i) { return i / GMAX < nrows && i % GMAX < ng; };
  int len_r[R], act_r[R];  // each row's keys and active partitions
  int len = 0;             // the longest row's keys
#pragma unroll
  for (int r = 0; r < R; ++r) {
    len_r[r] = r < nrows ? max(lens[b0 + r], 0) : 0;
    act_r[r] = min(parts, min((len_r[r] + block_size - 1) / block_size, max_blocks));
    len = max(len, len_r[r]);
  }
  const int nblk = min((len + block_size - 1) / block_size, max_blocks);
  const int active = min(parts, nblk);  // partitions holding a block of the longest row
  // the cluster's CTAs share a row, so these agree across the cluster
  const bool merge = split && active > 1;
  if (merge) cluster_arrive_relaxed();  // phase 1: this CTA has started
  if (split && rank > 0 && rank >= active) {  // no block: rank 0 writes the row
    if (merge) {
      cluster_wait();
      cluster_arrive();  // phase 2
    }
    return;
  }
  // this CTA's partitions: its rank, or all of its rows' (partition 0 of an
  // empty row, so that it writes zeros)
  const int p_first = rank, p_end = split ? rank + 1 : max(active, 1);

  const size_t q_row = (size_t)b0 * nh + (size_t)h * g + g0;  // slot i: + (i / GMAX) nh + i % GMAX
  auto slot_row = [&](int i) { return q_row + (size_t)(i / GMAX) * nh + i % GMAX; };
  const float qscale = scale * kLog2e;
  for (int idx = threadIdx.x; idx < NS * HD; idx += kThreads) {
    const int i = idx / HD;
    s_q[idx] = slot_ok(i) ? to_float(q[slot_row(i) * HD + idx % HD]) * qscale : 0.f;
  }

  const size_t head_off = (size_t)h * num_blocks * block_size * HD;
  const Keys keys{parts, block_size, len, nblk};
  Loader<T, HD> ld{k_pool + head_off, v_pool + head_off, tables + (size_t)b0 * max_blocks, keys};
  ld.p_end = p_end;
  ld.start(p_first);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kj = lane / C::L, ksub = lane % C::L;  // the lane's key in the warp, its dims
  const int kr = warp * C::KPW + kj;                // that key's row in the tile

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    ld.next(ring, s);
    cp_async_commit();
  }
  __syncthreads();  // s_q
  int gt = 0;       // tiles consumed: tile gt sits in stage gt % STAGES
  for (int p = p_first; p < p_end; ++p) {
    float m[NS], l[NS], acc[NS][C::VD];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < C::VD; ++e) acc[i][e] = 0.f;
    }
    const int nt = ld.ntiles(p);
    for (int t = 0; t < nt; ++t, ++gt) {
      // tile gt has landed (this thread's copies; the barrier makes every
      // thread's visible), and every warp is done with tile gt - 1's stage
      cp_async_wait<C::STAGES - 2>();
      __syncthreads();
      ld.next(ring, (gt + C::STAGES - 1) % C::STAGES);
      cp_async_commit();
      const T* const kt = ring + (gt % C::STAGES) * 2 * C::TILE;
      const T* const vt = kt + C::TILE;

      // scores: L lanes a key, 32 dims a lane, then summed over the L lanes
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
#pragma unroll
      for (int ci = 0; ci < C::CPL; ++ci) {
        const int c = ksub + C::L * ci;
        float kf[C::EPC];
        load_n<T, C::EPC>(kt + kr * HD + swz<T, HD>(kr, c) * C::EPC, kf);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          if (slot_ok(i)) {
            const float4* qv = reinterpret_cast<const float4*>(s_q + i * HD + c * C::EPC);
#pragma unroll
            for (int e4 = 0; e4 < C::EPC / 4; ++e4) {
              const float4 qq = qv[e4];
              sc[i] = fmaf(qq.x, kf[4 * e4], sc[i]);
              sc[i] = fmaf(qq.y, kf[4 * e4 + 1], sc[i]);
              sc[i] = fmaf(qq.z, kf[4 * e4 + 2], sc[i]);
              sc[i] = fmaf(qq.w, kf[4 * e4 + 3], sc[i]);
            }
          }
        }
      }
      const int pos = keys.pos(p, t * C::TK + kr);

      // the online softmax, once a tile: one max, one sum, one rescale
      float pr[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        pr[i] = 0.f;
        if (slot_ok(i)) {  // uniform across the CTA: no divergence around the shuffles
          const bool valid = pos < len_r[i / GMAX];
#pragma unroll
          for (int o = 1; o < C::L; o <<= 1) sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], o);
          const float s = valid ? sc[i] : kNegInf;
          float mt = s;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
          const float m_new = fmaxf(m[i], mt);
          const float alpha = exp2f(m[i] - m_new);
          pr[i] = valid ? exp2f(s - m_new) : 0.f;
          float ps = pr[i];
#pragma unroll
          for (int o = C::L; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
          l[i] = fmaf(l[i], alpha, ps);
#pragma unroll
          for (int e = 0; e < C::VD; ++e) acc[i][e] = __fmul_rn(acc[i][e], alpha);
          m[i] = m_new;
        }
      }

      // P.V: lanes over hd; key j's p from lane j * L
#pragma unroll
      for (int j = 0; j < C::KPW; ++j) {
        const int vr = warp * C::KPW + j;
        float vf[C::VD];
#pragma unroll
        for (int e = 0; e < C::VD; e += C::VE) {
          const int d = lane * C::VD + e;
          load_n<T, C::VE>(vt + vr * HD + swz<T, HD>(vr, d / C::EPC) * C::EPC + d % C::EPC,
                           vf + e);
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          if (slot_ok(i)) {
            const float pj = __shfl_sync(0xffffffffu, pr[i], j * C::L);
#pragma unroll
            for (int e = 0; e < C::VD; ++e) acc[i][e] = fmaf(pj, vf[e], acc[i][e]);
          }
        }
      }
    }

    // partition p done: the four warps' states, merged in warp order
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (slot_ok(i)) {
#pragma unroll
        for (int e = 0; e < C::VD; ++e) ws[warp * WSZ + i * HD + lane * C::VD + e] = acc[i][e];
        if (lane == 0) {
          ws[warp * WSZ + NS * HD + 2 * i] = m[i];
          ws[warp * WSZ + NS * HD + 2 * i + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (merge) cluster_wait();  // phase 1: every CTA of the cluster has started
    // the partition's state: the output itself when it is the row's only
    // one and its CTA's alone; a slot (rank 0's, through distributed shared
    // memory, for a CTA of rank > 0) when split over a cluster; else folded
    // into the running state, and the output after the row's last partition
    for (int idx = threadIdx.x; idx < NS * HD; idx += kThreads) {
      const int i = idx / HD, d = idx % HD;
      if (!slot_ok(i)) continue;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ws[w * WSZ + NS * HD + 2 * i]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = exp2f(ws[w * WSZ + NS * HD + 2 * i] - mx);
        lsum = fmaf(c, ws[w * WSZ + NS * HD + 2 * i + 1], lsum);
        a = fmaf(c, ws[w * WSZ + i * HD + d], a);
      }
      if (split) {
        float* const own = s_st + p * WSZ;
        if (!merge) {
          out[slot_row(i) * HD + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
        } else if (p == 0) {
          own[i * HD + d] = a;
          if (d == 0) {
            own[NS * HD + 2 * i] = mx;
            own[NS * HD + 2 * i + 1] = lsum;
          }
        } else {
          st_cluster(cluster_addr(own + i * HD + d, 0), a);
          if (d == 0) {
            st_cluster(cluster_addr(own + NS * HD + 2 * i, 0), mx);
            st_cluster(cluster_addr(own + NS * HD + 2 * i + 1, 0), lsum);
          }
        }
      } else {
        const int ar = max(act_r[i / GMAX], 1);  // the row's partitions (1 for an empty row)
        if (p < ar) {
          float* const ml = s_st + NS * HD;  // (m, l) of the running state after partition p
          if (p > 0) {  // the running state takes in partition p
            float mr = ml[((p - 1) * NS + i) * 2], lr = ml[((p - 1) * NS + i) * 2 + 1];
            float ar_ = s_st[idx];
            fold(mr, lr, ar_, mx, lsum, a);
            mx = mr, lsum = lr, a = ar_;
          }
          s_st[idx] = a;
          if (d == 0) {
            ml[(p * NS + i) * 2] = mx;
            ml[(p * NS + i) * 2 + 1] = lsum;
          }
          if (p == ar - 1) out[slot_row(i) * HD + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
        }
      }
    }
    __syncthreads();  // ws is free for the next partition
  }
  cp_async_wait<0>();
  if (!merge) return;
  cluster_arrive();  // phase 2: this partition's state is in rank 0
  if (rank != 0) return;
  cluster_wait();

  // the partitions' states, folded in partition order (R == 1: slot i is
  // query head g0 + i)
  for (int idx = threadIdx.x; idx < NS * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    if (!slot_ok(i)) continue;
    float mx = s_st[NS * HD + 2 * i], lsum = s_st[NS * HD + 2 * i + 1], a = s_st[idx];
    for (int r = 1; r < active; ++r) {
      const float* const st = s_st + r * WSZ;
      fold(mx, lsum, a, st[NS * HD + 2 * i], st[NS * HD + 2 * i + 1], st[idx]);
    }
    out[slot_row(i) * HD + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
}

// 16 bits: mma.sync.m16n8k16 with the CTA's 16 slots as the rows. Each
// tile: warp w scores keys [KW w, KW w + KW) (S = Q K^T, q's fragments held
// in registers, K by ldmatrix), the warps' row maxima and sums meet in
// shared memory (one max, one sum, one rescale a tile and row), P goes to
// shared memory in 16 bits, and warp w accumulates O[:, DW w, DW w + DW) =
// P V over all of the tile's keys (V by ldmatrix.trans). A thread holds
// rows g and g + 8 (g = lane / 4) of its fragments, and the partition's
// state (m, l, O) stays in registers.
template <typename T, int HD, int GMAX, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_mma_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool, const int32_t* __restrict__ tables,
                        const int32_t* __restrict__ lens, T* __restrict__ out, int batch, int nh,
                        int g, int num_blocks, int block_size, int max_blocks, int parts,
                        bool split, float scale) {
  using C = Cfg<T, HD>;
  constexpr int NS = R * GMAX;
  constexpr int WSZ = NS * (HD + 2);  // a stored state: acc[NS][HD], then (m, l)[NS]
  static_assert(NS <= kSlotsMma, "slots");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_diff[R];  // row b0 + r's table differs from row b0 + r - 1's
  T* const ring = reinterpret_cast<T*>(smem);
  T* const s_qh = reinterpret_cast<T*>(smem + C::STAGES * C::STAGE);  // [16][QLD]
  T* const s_p = s_qh + 16 * C::QLD;                                  // [16][PLD]
  float* const s_mx = reinterpret_cast<float*>(s_p + 16 * C::PLD);    // [kWarps][16]
  float* const s_sum = s_mx + kWarps * 16;                            // [kWarps][16]
  float* const s_st = s_sum + kWarps * 16;                            // split: [parts][WSZ]

  const int rank = split && parts > 1 ? int(cluster_ctarank()) : 0;
  const int b0 = split ? blockIdx.x / parts : blockIdx.x;
  int nrows = 1;
  if constexpr (R > 1) {
    nrows = group_rows<R>(tables, b0, batch, max_blocks, s_diff);
    if (nrows == 0) return;
  }
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * GMAX;  // first query head of this CTA's chunk
  const int ng = min(GMAX, g - g0);
  auto slot_ok = [&](int i) { return i < NS && i / GMAX < nrows && i % GMAX < ng; };
  int len = 0;  // the longest row's keys
  for (int r = 0; r < nrows; ++r) len = max(len, max(lens[b0 + r], 0));
  const int nblk = min((len + block_size - 1) / block_size, max_blocks);
  const int active = min(parts, nblk);
  const bool merge = split && active > 1;
  if (merge) cluster_arrive_relaxed();  // phase 1: this CTA has started
  if (split && rank > 0 && rank >= active) {  // no block: rank 0 writes the row
    if (merge) {
      cluster_wait();
      cluster_arrive();  // phase 2
    }
    return;
  }
  const int p_first = rank, p_end = split ? rank + 1 : max(active, 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // the fragment's row group and column pair
  // this thread's two slots (rows gq and gq + 8): their keys and partitions
  const size_t q_row = (size_t)b0 * nh + (size_t)h * g + g0;
  auto slot_row = [&](int i) { return q_row + (size_t)(i / GMAX) * nh + i % GMAX; };
  bool ok[2];
  int len_s[2], act_s[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = gq + 8 * hi;
    ok[hi] = slot_ok(i);
    len_s[hi] = ok[hi] ? max(lens[b0 + i / GMAX], 0) : 0;
    act_s[hi] = max(min(parts, min((len_s[hi] + block_size - 1) / block_size, max_blocks)), 1);
  }

  // q of the 16 slots in 16 bits (zeros past them), then its A fragments
  for (int idx = threadIdx.x; idx < 16 * (HD / 8); idx += kThreads) {
    const int i = idx / (HD / 8), c = idx % (HD / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (slot_ok(i)) v = *reinterpret_cast<const uint4*>(q + slot_row(i) * HD + c * 8);
    *reinterpret_cast<uint4*>(s_qh + i * C::QLD + c * 8) = v;
  }

  const size_t head_off = (size_t)h * num_blocks * block_size * HD;
  const Keys keys{parts, block_size, len, nblk};
  Loader<T, HD> ld{k_pool + head_off, v_pool + head_off, tables + (size_t)b0 * max_blocks, keys};
  ld.p_end = p_end;
  ld.start(p_first);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    ld.next(ring, s);
    cp_async_commit();
  }
  __syncthreads();  // s_qh
  uint32_t qa[C::KS][4];
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) ldsm_x4(qa[ks], a_at<C::QLD>(s_qh, 0, 16 * ks, lane));
  const float qscale = scale * kLog2e;

  // the running state of the rows (CTAs of many rows fold partitions here)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f}, o_run[C::NO][4] = {};
  int gt = 0;  // tiles consumed: tile gt sits in stage gt % STAGES
  for (int p = p_first; p < p_end; ++p) {
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[C::NO][4];
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    const int nt = ld.ntiles(p);
    for (int t = 0; t < nt; ++t, ++gt) {
      cp_async_wait<C::STAGES - 2>();
      __syncthreads();
      ld.next(ring, (gt + C::STAGES - 1) % C::STAGES);
      cp_async_commit();
      const T* const kt = ring + (gt % C::STAGES) * 2 * C::TILE;
      const T* const vt = kt + C::TILE;

      // S for the warp's keys: 8-key tiles n, 16-dim steps in pairs
      float s[C::NSN][4];
#pragma unroll
      for (int n = 0; n < C::NSN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        const int kr = C::KW * warp + 8 * n + (lane & 7);  // this lane's key row for ldmatrix
#pragma unroll
        for (int ks = 0; ks < C::KS; ks += 2) {
          uint32_t b[4];
          ldsm_x4(b, kt + kr * HD + swz<T, HD>(kr, 2 * ks + (lane >> 3)) * C::EPC);
          mma16816<T>(s[n], qa[ks], b[0], b[1]);
          mma16816<T>(s[n], qa[ks + 1], b[2], b[3]);
        }
      }
      // scaled, masked: fragment element e is row gq + 8 (e / 2), key 2 tq + e % 2
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < C::NSN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1;
          const int pos = keys.pos(p, t * C::TK + C::KW * warp + 8 * n + 2 * tq + (e & 1));
          s[n][e] = ok[hi] && pos < len_s[hi] ? __fmul_rn(s[n][e], qscale) : kNegInf;
          mx[hi] = fmaxf(mx[hi], s[n][e]);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
        if (tq == 0) s_mx[warp * 16 + gq + 8 * hi] = mx[hi];
      }
      __syncthreads();
      float alpha[2], ps[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float mt = s_mx[gq + 8 * hi];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, s_mx[w * 16 + gq + 8 * hi]);
        const float m_new = fmaxf(m[hi], mt);
        alpha[hi] = exp2f(m[hi] - m_new);
        m[hi] = m_new;
        ps[hi] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < C::NSN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1;
          s[n][e] = s[n][e] == kNegInf ? 0.f : exp2f(s[n][e] - m[hi]);
          ps[hi] += s[n][e];
        }
        const int col = C::KW * warp + 8 * n + 2 * tq;
        *reinterpret_cast<uint32_t*>(s_p + gq * C::PLD + col) = pack2<T>(s[n][0], s[n][1]);
        *reinterpret_cast<uint32_t*>(s_p + (gq + 8) * C::PLD + col) = pack2<T>(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        ps[hi] += __shfl_xor_sync(0xffffffffu, ps[hi], 1);
        ps[hi] += __shfl_xor_sync(0xffffffffu, ps[hi], 2);
        if (tq == 0) s_sum[warp * 16 + gq + 8 * hi] = ps[hi];
      }
      __syncthreads();
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float sum = s_sum[gq + 8 * hi];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += s_sum[w * 16 + gq + 8 * hi];
        l[hi] = fmaf(l[hi], alpha[hi], sum);
      }
#pragma unroll
      for (int n = 0; n < C::NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], alpha[e >> 1]);
      // O[:, warp's dims] += P V over the tile's keys, 16 at a time
#pragma unroll
      for (int kk = 0; kk < C::TK / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_at<C::PLD>(s_p, 0, 16 * kk, lane));
        const int vr = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;  // the lane's key row
        if constexpr (C::NO == 1) {
          uint32_t b[2];
          ldsm_x2_t(b, vt + vr * HD + swz<T, HD>(vr, C::DW * warp / 8) * C::EPC);
          mma16816<T>(o[0], a, b[0], b[1]);
        } else {
#pragma unroll
          for (int n = 0; n < C::NO; n += 2) {
            uint32_t b[4];
            const int c = (C::DW * warp + 8 * n) / 8 + (lane >> 4);
            ldsm_x4_t(b, vt + vr * HD + swz<T, HD>(vr, c) * C::EPC);
            mma16816<T>(o[n], a, b[0], b[1]);
            mma16816<T>(o[n + 1], a, b[2], b[3]);
          }
        }
      }
    }

    // partition p done: its state is the CTA's (m, l, o)
    if (merge) cluster_wait();  // phase 1: every CTA of the cluster has started
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = gq + 8 * hi;
      if (!ok[hi]) continue;
      float* const own = s_st + p * WSZ;
      if (split && merge) {  // the partition's state into rank 0's slot p
#pragma unroll
        for (int n = 0; n < C::NO; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = C::DW * warp + 8 * n + 2 * tq + e;
            if (p == 0) own[i * HD + d] = o[n][2 * hi + e];
            else st_cluster(cluster_addr(own + i * HD + d, 0), o[n][2 * hi + e]);
          }
        if (warp == 0 && tq == 0) {
          if (p == 0) {
            own[NS * HD + 2 * i] = m[hi];
            own[NS * HD + 2 * i + 1] = l[hi];
          } else {
            st_cluster(cluster_addr(own + NS * HD + 2 * i, 0), m[hi]);
            st_cluster(cluster_addr(own + NS * HD + 2 * i + 1, 0), l[hi]);
          }
        }
        continue;
      }
      bool last = split;  // the row's output now: its only partition, or its last
      if (!split && p < act_s[hi]) {
        if (p == 0) {
          m_run[hi] = m[hi];
          l_run[hi] = l[hi];
#pragma unroll
          for (int n = 0; n < C::NO; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) o_run[n][2 * hi + e] = o[n][2 * hi + e];
        } else {  // the running state takes in partition p
#pragma unroll
          for (int n = 0; n < C::NO; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float mr = m_run[hi], lr = l_run[hi];
              fold(mr, lr, o_run[n][2 * hi + e], m[hi], l[hi], o[n][2 * hi + e]);
            }
          float a_unused = 0.f;
          fold(m_run[hi], l_run[hi], a_unused, m[hi], l[hi], 0.f);
        }
        last = p == act_s[hi] - 1;
      }
      if (last) {
        const float lr = split ? l[hi] : l_run[hi];
        const float div = lr == 0.f ? 1.f : lr;
#pragma unroll
        for (int n = 0; n < C::NO; ++n) {
          const float a0 = split ? o[n][2 * hi] : o_run[n][2 * hi];
          const float a1 = split ? o[n][2 * hi + 1] : o_run[n][2 * hi + 1];
          const int d = C::DW * warp + 8 * n + 2 * tq;
          *reinterpret_cast<uint32_t*>(out + slot_row(i) * HD + d) = pack2<T>(a0 / div, a1 / div);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!merge) return;
  cluster_arrive();  // phase 2: this partition's state is in rank 0
  if (rank != 0) return;
  cluster_wait();

  // the partitions' states, folded in partition order (R == 1: slot i is
  // query head g0 + i)
  for (int idx = threadIdx.x; idx < NS * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    if (!slot_ok(i)) continue;
    float mx = s_st[NS * HD + 2 * i], lsum = s_st[NS * HD + 2 * i + 1], a = s_st[idx];
    for (int r = 1; r < active; ++r) {
      const float* const st = s_st + r * WSZ;
      fold(mx, lsum, a, st[NS * HD + 2 * i], st[NS * HD + 2 * i + 1], st[idx]);
    }
    out[slot_row(i) * HD + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* tables;
  const void* lens;
  void* out;
  int batch, num_heads, kv_heads, group, num_blocks, block_size, max_blocks, parts;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int GMAX, int R>
cudaError_t launch_shape(const Args& a, bool split, int chunks) {
  void (*kernel)(const T*, const T*, const T*, const int32_t*, const int32_t*, T*, int, int, int,
                 int, int, int, int, bool, float);
  if constexpr (Cfg<T, HD>::MMA) {
    kernel = paged_decode_mma_kernel<T, HD, GMAX, R>;
  } else {
    kernel = paged_decode_fma_kernel<T, HD, GMAX, R>;
  }
  const int bytes = smem_bytes<T, HD, GMAX, R>(split, a.parts);
  // above 48 KB dynamic shared memory needs the opt-in, once a device
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || allowed[dev] < bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.batch * (split ? a.parts : 1), a.kv_heads, chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split ? a.parts : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q),
                           static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
                           static_cast<const int32_t*>(a.tables),
                           static_cast<const int32_t*>(a.lens), static_cast<T*>(a.out), a.batch,
                           a.num_heads, a.group, a.num_blocks, a.block_size, a.max_blocks,
                           a.parts, split, a.scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Split the partitions over clusters only when the rows alone leave the
// card short of CTAs (decode: B * kvh * chunks below 4 CTAs an SM); more
// rows (prefill chunks, large batches) take R = 16 / GMAX (16 bits) or 8 /
// GMAX (fp32) rows of one table a CTA. The same arithmetic either way.
template <typename T, int HD, int GMAX>
cudaError_t launch(const Args& a) {
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) sms[dev] = n_sm;
  }
  const int chunks = (a.group + GMAX - 1) / GMAX;
  if ((long long)a.batch * a.kv_heads * chunks < 4ll * n_sm)
    return launch_shape<T, HD, GMAX, 1>(a, true, chunks);
  return launch_shape<T, HD, GMAX, (Cfg<T, HD>::MMA ? kSlotsMma : kSlotsFma) / GMAX>(a, false,
                                                                                   chunks);
}

template <typename T, int HD>
cudaError_t dispatch_group(const Args& a) {
  if (a.group >= 8) return launch<T, HD, 8>(a);
  if (a.group >= 4) return launch<T, HD, 4>(a);
  if (a.group >= 2) return launch<T, HD, 2>(a);
  return launch<T, HD, 1>(a);
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 32: return dispatch_group<T, 32>(a);
    case 64: return dispatch_group<T, 64>(a);
    case 128: return dispatch_group<T, 128>(a);
    case 256: return dispatch_group<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. parts: the partitions of a row
// (ops/transformer/paged_attention.py `plan`), 1 to 8 and at most
// max_blocks. Returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue for a shape the kernel does not take. Launches
// on `stream`; does not synchronise.
extern "C" int dstt_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                           const void* tables, const void* lens, void* out,
                                           int dtype, int batch, int num_heads, int kv_heads,
                                           int head_dim, int num_blocks, int block_size,
                                           int max_blocks, int parts, float scale, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || kv_heads > 65535 || num_heads % kv_heads != 0 ||
      block_size <= 0 || max_blocks <= 0 || num_blocks <= 0 || parts < 1 ||
      parts > kMaxParts || parts > max_blocks || (long long)batch * parts >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q,          k_pool,     v_pool,
               tables,     lens,       out,
               batch,      num_heads,  kv_heads,
               num_heads / kv_heads,   num_blocks, block_size,
               max_blocks, parts,      scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dispatch_head_dim<float>(head_dim, a);
    case 1: return (int)dispatch_head_dim<__nv_bfloat16>(head_dim, a);
    case 2: return (int)dispatch_head_dim<__half>(head_dim, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dstt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
