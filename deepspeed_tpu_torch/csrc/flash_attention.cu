// Flash attention forward and backward for NVIDIA Hopper (sm_90a), with
// plain C entry points for ctypes (built by deepspeed_tpu_torch/ops/op_builder.py).
//
// Replaces the TPU kernels in deepspeed_tpu/ops/transformer/flash_attention.py:
// `_fwd_kernel` (:43, launched by `_fwd` :98) and `_bwd_fused_kernel` (:124,
// launched by `_bwd` :189).
//
// What it computes: dense attention, as attention_kernels.cuh describes the
// kernels (which live there, shared with the block-sparse kernels); this
// file gives them the dense schedule below. p is rounded to v's dtype before
// P.V and dS to q's dtype before the dK and dQ products, as the TPU kernel
// does (:80, :163). Any S runs (a tail tile is masked), where the TPU kernel
// needed S to be a multiple of 128.
//
// What bounds it on this card: operations. At the training shape (S 2048,
// hd 128) the forward does 4 * S * S/2 * hd flops per (b, h) against
// 4 * S * hd bytes of q, k, v, o: ~1000 flops a byte, far above the H100's
// ~295 at which its bf16 tensor cores, and not its memory, are the limit.
//
// What the design does about it (attention_kernels.cuh has the detail).
// bf16 / fp16 run every tile product as mma.sync.m16n8k16 on the tensor
// cores, fed by ldmatrix, with each warp's 16 rows of scores, softmax state
// and accumulator in registers; P and dS go from the C fragments of one
// product into the A fragments of the next without a shared-memory round
// trip. K/V (and, for dK/dV, Q/dO) tiles stream through a two-stage
// cp.async ring, so the next tile's copy overlaps this tile's products.
// Causal tiles past the diagonal are skipped, masks run only on the
// diagonal and tail tiles, and the CTAs with the longest causal rows are
// scheduled first. A CTA is 4 warps: the forward's own 128 query rows (two
// 16-row m-tiles a warp; 64 at hd 256), dQ's 64 query rows, dK/dV's 64 key
// rows; key tiles are 64 keys (32 at hd 256).
//
// The backward is two kernels, not one. The TPU kernel accumulates dq in an
// output block that every KV step of its grid revisits (:138-140, :169): right
// only because a TPU grid runs its cells in order. CUDA CTAs run concurrently,
// so here a dK/dV kernel (one CTA per (b, kv head, key tile), looping over the
// group's g query heads and the query tiles that see the tile) writes dk and
// dv per KV head directly, with no per-query-head intermediate and no group
// sum outside, and a dQ kernel (one CTA per (b, head, query tile), looping
// over the visible key tiles) writes dq. Both are deterministic: no atomics.
//
// Left for later: wgmma with TMA and an mbarrier ring fed by a producer warp
// (warp specialisation), and a persistent schedule.

#include "attention_kernels.cuh"

namespace {

// Every key tile up to the diagonal (all of them unless causal); query tiles
// in reverse order, so the CTAs with the longest causal rows start first.
struct DenseSched {
  __device__ void fwd_cta(const Shape& s, int BQ, int& b, int& h, int& q0) const {
    const int nqt = (s.Sq + BQ - 1) / BQ;
    q0 = (nqt - 1 - int(blockIdx.x)) * BQ;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  __device__ int key_tiles(const Shape& s, int, int q0, int q_valid, int BK) const {
    const int n = (s.Skv + BK - 1) / BK;
    return s.causal ? min(n, (q0 + q_valid - 1) / BK + 1) : n;
  }
  __device__ int key_tile(const Shape&, int, int, int, int j, int BK) const { return j * BK; }
  __device__ void kv_cta(const Shape&, int BK, int& b, int& kh, int& k0) const {
    k0 = blockIdx.x * BK;
    kh = blockIdx.y;
    b = blockIdx.z;
  }
  // causal: from the first query tile that sees this key tile
  __device__ int query_tiles(const Shape& s, int, int k0, int BQ) const {
    return (s.Sq + BQ - 1) / BQ - (s.causal ? k0 / BQ : 0);
  }
  __device__ int query_tile(const Shape& s, int, int k0, int i, int BQ) const {
    return ((s.causal ? k0 / BQ : 0) + i) * BQ;
  }
  dim3 q_grid(const Shape& s, int BQ) const { return dim3((s.Sq + BQ - 1) / BQ, s.nh, s.B); }
  dim3 kv_grid(const Shape& s, int BK) const { return dim3((s.Skv + BK - 1) / BK, s.kvh, s.B); }
};

// The slot engine's forward (attention_kernels.cuh, RowOffsets): the dense
// schedule with each batch row's diagonal shifted by its offset off[b], so
// its key loop ends at the tile holding key q0 + q_valid - 1 + off, and its
// keys and values read from batch row rows[b] (rows null: row b).
struct SlotSched : DenseSched {
  const int* off;
  const int* rows;
  __device__ int key_tiles(const Shape& s, int, int q0, int q_valid, int BK, int off) const {
    const int n = (s.Skv + BK - 1) / BK;
    return s.causal ? min(n, (q0 + off + q_valid - 1) / BK + 1) : n;
  }
};

template <>
struct RowOffsets<SlotSched> {
  static constexpr bool value = true;
};

// Two 16-row m-tiles a forward warp, 128 query rows a CTA: at the training
// shape (B 2, S 2048, 32 heads, hd 128, bf16, causal) the forward took
// 0.436 ms with one m-tile and 0.34 with two (chip_ab.py, NVIDIA H100 80GB
// HBM3, 700 W; PERF.md section 6). The slot forward keeps one (the default):
// with two its hd-128 instantiations spilled 112 bytes at 255 registers, and
// one took its decode call (8 rows of one query over a 4096-token cache)
// from 0.098 to 0.061 ms and a 256-row chunk from 0.030 to 0.021 (168
// registers, no spill; chip_ab.py, same card and limit).
template <>
struct FwdWarpTiles<DenseSched> {
  static constexpr int value = 2;
};

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. `strides` holds 12 element strides
// (batch, sequence, head) of q, k, v and, for the backward, do; the outputs
// are contiguous: o / dq (B, Sq, nh, hd), dk / dv (B, Skv, kvh, hd), lse
// (B, nh, Sq) fp32. Returns cudaGetLastError() after the launches (0 =
// launched), or cudaErrorInvalidValue for a shape the kernels do not take.
// Launches on `stream`; does not synchronise. The forward's `q_offset` and
// `kv_rows` are (batch,) int32 on the device, or null; with offsets it runs
// SlotSched (with `kv_rows` k and v may have any batch), and `kv_rows`
// needs them (zeros for none).
extern "C" int dstt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int dtype, int batch, int seq_q, int seq_kv,
                                        int num_heads, int kv_heads, int head_dim, int causal,
                                        float scale, const long long* strides,
                                        const void* q_offset, const void* kv_rows,
                                        void* stream) {
  Args a{};
  if (!make_shape(&a.s, batch, seq_q, seq_kv, num_heads, kv_heads, causal, scale, strides)) {
    return (int)cudaErrorInvalidValue;
  }
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
  a.stream = static_cast<cudaStream_t>(stream);
  if (q_offset) {
    SlotSched slot{};
    slot.off = static_cast<const int*>(q_offset);
    slot.rows = static_cast<const int*>(kv_rows);
    return (int)dispatch(dtype, head_dim, false, a, slot);
  }
  if (kv_rows) return (int)cudaErrorInvalidValue;  // rows need the slot schedule's offsets
  return (int)dispatch(dtype, head_dim, false, a, DenseSched{});
}

extern "C" int dstt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, int dtype, int batch,
                                        int seq_q, int seq_kv, int num_heads, int kv_heads,
                                        int head_dim, int causal, float scale,
                                        const long long* strides, void* stream) {
  Args a{};
  if (!make_shape(&a.s, batch, seq_q, seq_kv, num_heads, kv_heads, causal, scale, strides)) {
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
  return (int)dispatch(dtype, head_dim, true, a, DenseSched{});
}
