// Block-sparse attention forward and backward for NVIDIA Hopper (sm_90a), with
// plain C entry points for ctypes (built by deepspeed_tpu_torch/ops/op_builder.py).
//
// Replaces the TPU kernels in deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:
// `_fwd_kernel` (:64, launched by `_sparse_fwd` :181), `_bwd_dq_kernel` (:99,
// launched at :211) and `_bwd_dkv_kernel` (:131, launched at :229).
//
// What it computes. Flash attention (attention_kernels.cuh) restricted to a
// block layout of (heads, Sq / block, Skv / block): query block i of head h
// visits only the kcnt[h, i] key blocks kidx[h, i, :kcnt], in list order, and
// inside a visited block a key is visible unless causal and qpos < kpos. A
// query block that visits nothing gets o = 0, lse = -1e30 and dq = 0, as the
// TPU kernel does (:94-96). The lists come from `layout_to_lists`, made on the
// host once per layout and kept on the card.
//
// What bounds it on this card: operations. At llama-7b's heads (hd 128), S
// 8192 and the Fixed layout (local 4, global 1, causal) the visited block
// pairs cost ~0.165 ms of bf16 tensor-core time forward, against ~0.08 ms to
// read q, k, v and write o once. But a visited 128 x 128 pair does 4 * 128^2
// * 128 flops per 2 * 128 * 128 * 2 bytes of K and V, 128 flops a byte, under
// the H100's ~295: K and V re-read for every visit have to come from L2, not
// device memory. The layout decides how many pairs there are; the kernels do
// only that work.
//
// What the design does about it. The kernels are the flash kernels over
// another schedule (ListSched below): a CTA of the forward and the dQ kernel
// takes one query tile of one head and walks the key tiles of its row's list,
// a layout block being several tiles; a CTA of the dK/dV kernel takes one key
// tile of one KV head and walks, for each of the group's g query heads, the
// query tiles of that head's column list (qcnt, qidx), writing dk and dv per
// KV head with no atomics and no group sum outside (the TPU kernel wrote them
// per query head and summed after, :243-248). Under causal, tiles wholly past
// the diagonal are skipped. Rows' work is uneven (a global row visits every
// block, a window row a few), so the CTAs run in the order of `q_order` and
// `kv_order`, longest lists first, and the long rows do not form a tail.
//
// The tiles are the flash kernels' (attention_kernels.cuh): 64 query rows
// and 64 key rows a CTA, 64-key tiles (32 at hd 256), so a block of any
// multiple of 64 is walked as whole tiles, and the accumulators live in
// registers.
//
// Left for later: the flash kernels' list (wgmma, TMA, warp
// specialisation), and splitting a global row's list over several CTAs.

#include "attention_kernels.cuh"

namespace {

struct ListSched {
  const int* kcnt;      // (nh, nQ) key blocks of each query block
  const int* kidx;      // (nh, nQ, maxk) their indices
  const int* qcnt;      // (nh, nK) query blocks of each key block
  const int* qidx;      // (nh, nK, maxq) their indices
  const int* q_order;   // (nh * nQ) h * nQ + i, longest kcnt first
  const int* kv_order;  // (kvh * nK) kh * nK + j, longest group sum of qcnt first
  int blk, nQ, nK, maxk, maxq;

  __device__ void fwd_cta(const Shape&, int BQ, int& b, int& h, int& q0) const {
    const int per = blk / BQ;
    const int item = q_order[blockIdx.x / per];
    h = item / nQ;
    q0 = (item % nQ) * blk + (blockIdx.x % per) * BQ;
    b = blockIdx.y;
  }
  __device__ int key_tiles(const Shape&, int h, int q0, int, int BK) const {
    return kcnt[h * nQ + q0 / blk] * (blk / BK);
  }
  __device__ int key_tile(const Shape& s, int h, int q0, int q_valid, int j, int BK) const {
    const int per = blk / BK;
    const int kb = kidx[(size_t(h) * nQ + q0 / blk) * maxk + j / per];
    const int k0 = kb * blk + (j % per) * BK;
    return s.causal && k0 > q0 + q_valid - 1 ? -1 : k0;  // past every row's diagonal
  }
  __device__ void kv_cta(const Shape&, int BK, int& b, int& kh, int& k0) const {
    const int per = blk / BK;
    const int item = kv_order[blockIdx.x / per];
    kh = item / nK;
    k0 = (item % nK) * blk + (blockIdx.x % per) * BK;
    b = blockIdx.y;
  }
  __device__ int query_tiles(const Shape&, int h, int k0, int BQ) const {
    return qcnt[h * nK + k0 / blk] * (blk / BQ);
  }
  __device__ int query_tile(const Shape& s, int h, int k0, int i, int BQ) const {
    const int per = blk / BQ;
    const int qb = qidx[(size_t(h) * nK + k0 / blk) * maxq + i / per];
    const int q0 = qb * blk + (i % per) * BQ;
    return s.causal && q0 + BQ - 1 < k0 ? -1 : q0;  // every row before the tile's first key
  }
  dim3 q_grid(const Shape& s, int BQ) const { return dim3(s.nh * nQ * (blk / BQ), s.B); }
  dim3 kv_grid(const Shape& s, int BK) const { return dim3(s.kvh * nK * (blk / BK), s.B); }
};

bool make_sched(ListSched* l, const Shape& s, const int* kcnt, const int* kidx, const int* qcnt,
                const int* qidx, const int* q_order, const int* kv_order, int block, int max_k,
                int max_q) {
  // 64 is the largest tile (Mma<>::BQ, BK, BQ2): a block of a multiple of
  // it is walked as whole tiles
  if (block <= 0 || block % 64 || s.Sq % block || s.Skv % block || max_k <= 0 || max_q <= 0) {
    return false;
  }
  *l = ListSched{kcnt, kidx, qcnt, qidx, q_order, kv_order, block, s.Sq / block, s.Skv / block,
                 max_k, max_q};
  return true;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. `strides` holds 12 element strides
// (batch, sequence, head) of q, k, v and, for the backward, do; the outputs
// are contiguous: o / dq (B, Sq, nh, hd), dk / dv (B, Skv, kvh, hd), lse
// (B, nh, Sq) fp32. The six lists are int32 on the card, as
// `layout_to_lists` and the orders make them; the forward reads kcnt, kidx
// and q_order. `block` is the layout's block, a multiple of 64 that divides
// both sequence lengths. Returns cudaGetLastError() after the launches (0 =
// launched), or cudaErrorInvalidValue for a shape the kernels do not take.
// Launches on `stream`; does not synchronise.
extern "C" int dstt_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const int* kcnt,
    const int* kidx, const int* qcnt, const int* qidx, const int* q_order, const int* kv_order,
    int dtype, int batch, int seq_q, int seq_kv, int num_heads, int kv_heads, int head_dim,
    int causal, float scale, int block, int max_k, int max_q, const long long* strides,
    void* stream) {
  Args a{};
  ListSched l{};
  if (!make_shape(&a.s, batch, seq_q, seq_kv, num_heads, kv_heads, causal, scale, strides) ||
      !make_sched(&l, a.s, kcnt, kidx, qcnt, qidx, q_order, kv_order, block, max_k, max_q)) {
    return (int)cudaErrorInvalidValue;
  }
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
  a.stream = static_cast<cudaStream_t>(stream);
  return (int)dispatch(dtype, head_dim, false, a, l);
}

extern "C" int dstt_block_sparse_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, const int* kcnt, const int* kidx,
    const int* qcnt, const int* qidx, const int* q_order, const int* kv_order, int dtype,
    int batch, int seq_q, int seq_kv, int num_heads, int kv_heads, int head_dim, int causal,
    float scale, int block, int max_k, int max_q, const long long* strides, void* stream) {
  Args a{};
  ListSched l{};
  if (!make_shape(&a.s, batch, seq_q, seq_kv, num_heads, kv_heads, causal, scale, strides) ||
      !make_sched(&l, a.s, kcnt, kidx, qcnt, qidx, q_order, kv_order, block, max_k, max_q)) {
    return (int)cudaErrorInvalidValue;
  }
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.o = dq;
  a.dk = dk;
  a.dv = dv;
  a.stream = static_cast<cudaStream_t>(stream);
  return (int)dispatch(dtype, head_dim, true, a, l);
}
