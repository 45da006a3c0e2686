"""The port's fused linear cross-entropy (``fused_ce_loss``).

On the CPU, on the same numpy-seeded inputs as the JAX package, whose Pallas
kernels run in interpret mode as ``tests/unit/test_models.py:144`` runs them:

- fp32 (N 256, H 128, V 768), the JAX test's shape, and fp32 (256, 8192,
  256), the gate's H edge (``block_r`` 128, so 2 dW partials there): nll at
  rtol/atol 1e-5, dx and dw of ``(nll * g).sum()`` against ``jax.grad`` at
  rtol 1e-4 / atol 1e-5, the JAX package's own tolerances
  (``tests/unit/test_models.py:161-169``);
- bf16 (2560, 128, 640), 5 row blocks and 5 vocab blocks: nll at atol 1e-4;
  dx and dw at 1e-2 of their max. The JAX package rounds each of its 5 dW
  partials to bf16 before adding them and the port rounds dW once, so the
  two differ by those roundings;
- labels -1 and V give lse in both packages;
- both packages raise ``NotImplementedError`` on the same shapes, and
  ``ValueError`` when H differs;
- under ``torch.no_grad()`` (or with nothing requiring grad) the forward
  asks for no residual;
- the plain version against a straightforward fp32 logsumexp - gather with
  autograd;
- the kernels' planner (``plan``, ``cta_tiles``), a pure function: the
  pinned plans at llama-7b's and gpt2-6.7b's heads, every output tile of
  the three 16-bit products walked once, the forward's chunks in vocab
  order (and the ordered merge of their partials equal to logsumexp), and
  the half tiles where N, V or H is 128 mod 256 reached.

On a card (``cuda``-marked, skipped here): the CUDA kernels against the
plain versions at small shapes, at (384, 640, 50304) (N, H and V each 128
mod 256: a half tile on every side of the 16-bit kernels' 128 x 256 tiles)
and at gpt2-6.7b's head (4096, 4096, 50304), lse and nll at atol 1e-4 (both sum exact
products in fp32, in another order); for 16-bit types lg, dx and dw
elementwise at rtol x (|ref| + median |ref|), rtol 1e-2 for bf16 and 2e-3
for fp16 (a sum on a rounding boundary may round the other way); for fp32
lg at atol 1e-4 (the sums' orders differ by 1.4e-5 at H 8192) and dx, dw
at 1e-5 of max(1, their max); the backward's reference runs on the forward
kernel's residual; a second forward and backward bitwise equal to the
first (no atomics). The
card has no JAX, so this file imports it only in the tests that use it, and
runs there with ``python -m pytest --noconftest -m cuda
tests/test_torch_fused_ce.py``.
"""

import functools

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import fused_ce as fc

# name: (N, H, V, dtype)
CASES = {
    "fp32-jax-test-shape": (256, 128, 768, "float32"),
    "fp32-h-edge": (256, 8192, 256, "float32"),
    "bf16-5x5-blocks": (2560, 128, 640, "bfloat16"),
}


def inputs(N, H, V, seed=0):
    """x, w, labels (with -1 and V among them) and g, as fp32/int32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H)).astype(np.float32)
    w = (rng.standard_normal((V, H)) * (1.5 / np.sqrt(H))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[:2] = (-1, V)
    g = rng.standard_normal(N).astype(np.float32)
    return x, w, labels, g


def as_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def jax_ref():
    """name -> (nll, dx, dw) of the JAX package's ``fused_ce_loss`` as fp32
    numpy, each computed once."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    jfc = pytest.importorskip("deepspeed_tpu.ops.transformer.fused_ce")

    @functools.lru_cache(maxsize=None)
    def run(name):
        N, H, V, dtype = CASES[name]
        x, w, labels, g = inputs(N, H, V)
        # the port's inputs rounded to the dtype, handed over exactly
        xj, wj = (jnp.asarray(as_torch(a, dtype).float().numpy()).astype(dtype) for a in (x, w))
        lab = jnp.asarray(labels)
        nll = jfc.fused_ce_loss(xj, wj, lab)
        dx, dw = jax.grad(lambda a, b: jnp.sum(jfc.fused_ce_loss(a, b, lab) * g),
                          argnums=(0, 1))(xj, wj)
        return tuple(np.asarray(t, np.float32) for t in (nll, dx, dw))

    return run


def port(name):
    """(nll, dx, dw, lse) of the port on the CPU."""
    N, H, V, dtype = CASES[name]
    x, w, labels, g = inputs(N, H, V)
    xt, wt = (as_torch(a, dtype).requires_grad_() for a in (x, w))
    lab = torch.from_numpy(labels)
    nll = fc.fused_ce_loss(xt, wt, lab)
    dx, dw = torch.autograd.grad((nll * torch.from_numpy(g)).sum(), (xt, wt))
    _, lse, _ = fc.fused_ce_fwd_plain(xt.detach(), wt.detach(), lab, write_logits=False)
    return nll.detach(), dx, dw, lse


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_jax(name, jax_ref):
    N, H, V, dtype = CASES[name]
    want_nll, want_dx, want_dw = jax_ref(name)
    nll, dx, dw, _ = port(name)
    assert nll.dtype == torch.float32 and nll.shape == (N,)
    assert dx.dtype == dw.dtype == getattr(torch, dtype)
    assert dx.shape == (N, H) and dw.shape == (V, H)
    if dtype == "float32":
        np.testing.assert_allclose(nll.numpy(), want_nll, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(nll.numpy(), want_nll, rtol=0, atol=1e-4)
        for got, want in ((dx, want_dx), (dw, want_dw)):
            err = np.abs(got.float().numpy() - want).max()
            assert err <= 1e-2 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name", ["fp32-jax-test-shape", "bf16-5x5-blocks"])
def test_out_of_range_labels_give_lse(name, jax_ref):
    """Rows 0 and 1 carry labels -1 and V: no column is hit, so nll = lse."""
    jfc = pytest.importorskip("deepspeed_tpu.ops.transformer.fused_ce")
    import jax.numpy as jnp

    N, H, V, dtype = CASES[name]
    nll, _, _, lse = port(name)
    assert torch.equal(nll[:2], lse[:2])
    x, w, labels, _ = inputs(N, H, V)
    xj, wj = (jnp.asarray(as_torch(a, dtype).float().numpy()).astype(dtype) for a in (x, w))
    # the JAX kernel's own lse and gold (block sizes as fused_ce_loss picks them)
    block_r, block_v = jfc._pick_blocks(N, V, H)
    _, jlse, jgold = jfc._ce_fwd_impl(xj, wj, jnp.asarray(labels), block_r, block_v)
    assert np.all(np.asarray(jgold)[:2] == 0.0)
    np.testing.assert_allclose(jax_ref(name)[0][:2], np.asarray(jlse)[:2], rtol=0, atol=0)
    np.testing.assert_allclose(lse[:2].numpy(), np.asarray(jlse)[:2], rtol=1e-5, atol=1e-5)


GATE_SHAPES = [(100, 128, 256), (256, 128, 50257), (256, 64, 256), (256, 8320, 256)]


@pytest.mark.parametrize("N,H,V", GATE_SHAPES)
def test_gate_raises_where_jax_raises(N, H, V):
    jfc = pytest.importorskip("deepspeed_tpu.ops.transformer.fused_ce")
    import jax.numpy as jnp

    with pytest.raises(NotImplementedError):
        jfc.fused_ce_loss(jnp.zeros((N, H)), jnp.zeros((V, H)), jnp.zeros((N,), jnp.int32))
    with pytest.raises(NotImplementedError):
        fc.fused_ce_loss(torch.zeros(N, H), torch.zeros(V, H), torch.zeros(N, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        fc.check_kernel_config(N, V, H, torch.bfloat16)


def test_h_mismatch_raises_value_error_in_both():
    jfc = pytest.importorskip("deepspeed_tpu.ops.transformer.fused_ce")
    import jax.numpy as jnp

    with pytest.raises(ValueError):
        jfc.fused_ce_loss(jnp.zeros((128, 128)), jnp.zeros((128, 256)),
                          jnp.zeros((128,), jnp.int32))
    with pytest.raises(ValueError):
        fc.fused_ce_loss(torch.zeros(128, 128), torch.zeros(128, 256),
                         torch.zeros(128, dtype=torch.int32))


def test_kernel_config_raises_for_a_dtype_without_kernel():
    fc.check_kernel_config(128, 256, 128, torch.float16)
    with pytest.raises(NotImplementedError):
        fc.check_kernel_config(128, 256, 128, torch.float64)


def test_residual_only_when_autograd_needs_it(monkeypatch):
    asked = []
    real = fc.fused_ce_fwd

    def recording(x, w, labels, write_logits=True):
        asked.append(write_logits)
        return real(x, w, labels, write_logits)

    monkeypatch.setattr(fc, "fused_ce_fwd", recording)
    x, w, labels, _ = inputs(128, 128, 256)
    xt, wt, lab = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels)
    want = fc.fused_ce_fwd_plain(xt, wt, lab, write_logits=False)[2]
    got = fc.fused_ce_loss(xt, wt, lab)  # nothing requires grad
    with torch.no_grad():
        got_ng = fc.fused_ce_loss(xt.requires_grad_(), wt, lab)
    got_g = fc.fused_ce_loss(xt, wt, lab.long())  # x requires grad, grad mode on
    assert asked == [False, False, True]
    assert not got_ng.requires_grad and got_g.requires_grad
    for out in (got, got_ng, got_g):
        assert torch.equal(out.detach(), want)


def test_plain_matches_autograd_reference():
    """The plain versions through the autograd Function against fp32
    ``logsumexp - gather`` differentiated by autograd (valid labels)."""
    N, H, V = 256, 128, 384
    x, w, labels, g = inputs(N, H, V, seed=3)
    labels = np.random.default_rng(4).integers(0, V, N).astype(np.int32)
    lab = torch.from_numpy(labels)
    gt = torch.from_numpy(g)
    xr, wr = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    s = xr @ wr.t()
    ref = torch.logsumexp(s, -1) - s.gather(1, lab.long()[:, None])[:, 0]
    ref_dx, ref_dw = torch.autograd.grad((ref * gt).sum(), (xr, wr))
    xp, wp = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    nll = fc.fused_ce_loss(xp, wp, lab)
    dx, dw = torch.autograd.grad((nll * gt).sum(), (xp, wp))
    torch.testing.assert_close(nll, ref.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, ref_dx, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dw, ref_dw, rtol=1e-4, atol=1e-5)


H100_SMS = 132
# (N, H, V): llama-7b's and gpt2-6.7b's heads at a 2 x 2048 batch, and a
# head whose N, H and V are each 128 mod 256 (a half tile on every side)
PLAN_SHAPES = [(4096, 4096, 32000), (4096, 4096, 50304), (384, 640, 50304)]


def test_plan_fills_the_card_with_whole_vocab_tiles():
    """16-bit: one persistent CTA an SM, 128 x 256 tiles; the forward's
    chunks leave no CTA more than one tile above the even share, and of
    those plans the chunk count is the least; fp32 keeps the FMA kernels'
    (tiles a CTA, chunks) from waves of 64 x 128 tiles."""
    for N, H, V in PLAN_SHAPES:
        p = fc.plan(N, V, H, torch.bfloat16, 1, H100_SMS)
        assert (p.tile_m, p.tile_n) == (128, 256)
        mt, nt = N // 128, -(-V // 256)
        assert p.tiles_per_chunk * (p.chunks - 1) < nt <= p.tiles_per_chunk * p.chunks
        assert p.fwd_ctas == min(H100_SMS, mt * p.chunks)
        most = max(len(t) for t in fc.cta_tiles(mt, nt, p.tiles_per_chunk, p.fwd_ctas))
        assert most <= -(-mt * nt // H100_SMS) + 1
        assert p.dx_ctas == min(H100_SMS, mt * -(-H // 256))
        assert p.dw_ctas == min(H100_SMS, V // 128 * -(-H // 256))
        assert fc.plan(N, V, H, torch.float16, 1, H100_SMS) == p
    assert fc.plan(4096, 32000, 4096, torch.bfloat16, 1, H100_SMS)[2:4] == (1, 125)
    assert fc.plan(4096, 50304, 4096, torch.bfloat16, 1, H100_SMS)[2:4] == (6, 33)
    assert fc.plan(384, 50304, 640, torch.bfloat16, 1, H100_SMS)[2:4] == (5, 40)
    # fp32: two FMA forward CTAs an SM, waves of 64 x 128 tiles
    assert fc.plan(4096, 50304, 4096, torch.float32, 2, H100_SMS)[2:4] == (12, 33)
    assert fc.plan(256, 768, 128, torch.float32, 2, H100_SMS)[2:4] == (1, 6)


def _products(N, H, V, p):
    """(name, row blocks, column tiles, tiles a chunk, CTAs, columns fastest)
    of the three 16-bit products under plan p."""
    ht = -(-H // 256)
    return [("fwd", N // 128, -(-V // 256), p.tiles_per_chunk, p.fwd_ctas, False),
            ("dx", N // 128, ht, 1, p.dx_ctas, False),
            ("dw", V // 128, ht, 1, p.dw_ctas, True)]


@pytest.mark.parametrize("N,H,V", PLAN_SHAPES + [(256, 128, 768), (2560, 128, 640)])
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_schedule_covers_every_output_tile_once(N, H, V, sms):
    p = fc.plan(N, V, H, torch.bfloat16, 1, sms)
    for name, mt, nt, per, ctas, n_fastest in _products(N, H, V, p):
        assert 0 < ctas <= sms
        seen = [(m, t) for tiles in fc.cta_tiles(mt, nt, per, ctas, n_fastest)
                for m, _, t in tiles]
        assert sorted(seen) == [(m, t) for m in range(mt) for t in range(nt)], name


@pytest.mark.parametrize("N,H,V", PLAN_SHAPES)
def test_forward_chunks_merge_in_order(N, H, V):
    """Each row block's chunks hold consecutive vocab tiles, chunk c before
    c + 1, so merging the partials in chunk order walks the vocab in order;
    and that merge, done as ce_combine_kernel does it on (m, l, gold) per
    (row, chunk), gives the logsumexp and the gold logit."""
    p = fc.plan(N, V, H, torch.bfloat16, 1, H100_SMS)
    mt, nt = N // 128, -(-V // 256)
    by_block = {}
    for tiles in fc.cta_tiles(mt, nt, p.tiles_per_chunk, p.fwd_ctas):
        for m, c, t in tiles:
            by_block.setdefault(m, {}).setdefault(c, []).append(t)
    for m in range(mt):
        chunks = by_block[m]
        assert sorted(chunks) == list(range(p.chunks))
        assert [t for c in sorted(chunks) for t in chunks[c]] == list(range(nt))
    # the merge on 8 rows of random logits, at the plan's chunk edges
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.standard_normal((8, V)).astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(0, V, 8))
    edges = [min(V, c * p.tiles_per_chunk * 256) for c in range(p.chunks + 1)]
    m_run = l_run = gold = None
    for c in range(p.chunks):
        part = s[:, edges[c]:edges[c + 1]]
        mc = part.max(1).values
        lc = torch.exp(part - mc[:, None]).sum(1)
        hit = ((labels >= edges[c]) & (labels < edges[c + 1]))
        gc = torch.where(hit, s.gather(1, labels[:, None])[:, 0], torch.zeros(8))
        if c == 0:
            m_run, l_run, gold = mc, lc, gc
        else:
            m_new = torch.maximum(m_run, mc)
            l_run = l_run * torch.exp(m_run - m_new) + lc * torch.exp(mc - m_new)
            m_run, gold = m_new, gold + gc
    torch.testing.assert_close(m_run + torch.log(l_run), torch.logsumexp(s, 1), rtol=0,
                               atol=1e-5)
    assert torch.equal(gold, s.gather(1, labels[:, None])[:, 0])


@pytest.mark.parametrize("V", [7, 768, 50304])
def test_label_rows_group_rows_by_label_in_row_order(V):
    """The 16-bit backward's index of the label terms: every row with a
    label in [0, V) once, grouped by label, ascending within a label; rows
    labelled -1 or V nowhere; each label that some row has a scratch slot,
    numbered in label order, and vlist the inverse (CPU labels: the plain
    version)."""
    rng = np.random.default_rng(V)
    N = 1000
    labels = rng.integers(-1, V + 1, N).astype(np.int32)
    labels[:4] = (-1, V, 0, V - 1)
    order, starts, slot, vlist = fc.label_rows(torch.from_numpy(labels), V)
    assert {t.dtype for t in (order, starts, slot, vlist)} == {torch.int32}
    assert order.shape == (N,) and starts.shape == (V + 1,) and slot.shape == (V,)
    assert vlist.shape == (min(N, V),)
    assert starts[0] == 0 and starts[-1] == int(((labels >= 0) & (labels < V)).sum())
    named = sorted(set(labels.tolist()) & set(range(V)))
    for v in range(V):
        rows = order[starts[v]:starts[v + 1]].tolist()
        assert rows == np.flatnonzero(labels == v).tolist()
        assert slot[v] == (named.index(v) if rows else -1)
    assert vlist.tolist() == named + [-1] * (min(N, V) - len(named))


@pytest.mark.parametrize("N,H,V", [(4096, 4096, 50304), (384, 640, 50304), (256, 640, 384)])
def test_tails_are_covered(N, H, V):
    """V and H of 128 mod 256 end in a half tile: the schedule reaches the
    tile that holds the last 128 columns, and no tile lies past them."""
    p = fc.plan(N, V, H, torch.bfloat16, 1, H100_SMS)
    for name, mt, nt, per, ctas, n_fastest in _products(N, H, V, p):
        cols = V if name == "fwd" else H
        last = max(t for tiles in fc.cta_tiles(mt, nt, per, ctas, n_fastest)
                   for _, _, t in tiles)
        assert last * 256 < cols <= (last + 1) * 256, name
        if cols % 256:
            assert cols - last * 256 == 128, name


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close_rel(got, want, tol, floor=0.0):
    scale = max(floor, want.float().abs().max().item() + 1e-6)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, f"max err {err:.3g} > {tol} x {scale:.3g}"


def _close16(got, want, dtype):
    """16-bit outputs elementwise, |err| <= rtol (|ref| + median |ref|):
    one rounding to 16 bits may go the other way (<= 2^-7 of the value in
    bf16, 2^-10 in fp16); the median term covers elements near 0."""
    rtol = {torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype]
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    bad = int((err > rtol * (ref + ref.median())).sum())
    assert not bad, f"{bad} elements outside {rtol} x (|ref| + median), max err {err.max():.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("N,H,V", [(256, 128, 768), (2560, 128, 640), (256, 8192, 256),
                                   (384, 640, 50304), (4096, 4096, 50304)])
def test_cuda_kernels_match_plain(N, H, V, dtype, cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, labels, g = inputs(N, H, V)
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    lab, gt = torch.from_numpy(labels).to(cuda), torch.from_numpy(g).to(cuda)
    f0, b0 = fc.fwd_launches, fc.bwd_launches
    lg, lse, nll = fc.fused_ce_fwd(xt, wt, lab)
    again = fc.fused_ce_fwd(xt, wt, lab)
    _, lse_nr, nll_nr = fc.fused_ce_fwd(xt, wt, lab, write_logits=False)
    dx, dw = fc.fused_ce_bwd(lg, lse, lab, gt, xt, wt)
    dx2, dw2 = fc.fused_ce_bwd(lg, lse, lab, gt, xt, wt)
    torch.cuda.synchronize()
    assert (fc.fwd_launches, fc.bwd_launches) == (f0 + 3, b0 + 2)
    for a, b in ((lg, again[0]), (lse, again[1]), (nll, again[2]), (lse, lse_nr),
                 (nll, nll_nr), (dx, dx2), (dw, dw2)):
        assert torch.equal(a, b), "the kernels do not repeat bitwise"
    ref_lg, ref_lse, ref_nll = fc.fused_ce_fwd_plain(xt, wt, lab)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(nll, ref_nll, atol=1e-4, rtol=0)
    # fp32: the kernel sums up to 8192 products in order, cuBLAS in another
    # (1.4e-5 apart at H 8192); 16-bit: a sum on a rounding boundary rounds
    # the other way (one ulp)
    ref_dx, ref_dw = fc.fused_ce_bwd_plain(lg, lse, lab, gt, xt, wt)
    if dtype == torch.float32:
        torch.testing.assert_close(lg, ref_lg, atol=1e-4, rtol=0)
        _close_rel(dx, ref_dx, 1e-5, 1.0)
        _close_rel(dw, ref_dw, 1e-5, 1.0)
    else:
        for got, want in ((lg, ref_lg), (dx, ref_dx), (dw, ref_dw)):
            _close16(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V", [(1000, 7), (4096, 32000), (384, 50304), (2048, 2048)])
def test_cuda_label_rows_match_plain(N, V, cuda):
    """The label-index kernel against its plain version: bitwise, order in
    its first starts[V] entries; labels with -1, V, many repeats and one
    label on a quarter of the rows."""
    rng = np.random.default_rng(N + V)
    labels = rng.integers(-1, V + 1, N).astype(np.int32)
    labels[: N // 4] = V // 2
    lab = torch.from_numpy(labels).to(cuda)
    got = fc.label_rows(lab, V)
    want = fc.label_rows_plain(lab, V)
    torch.cuda.synchronize()
    valid = int(want[1][-1])
    assert torch.equal(got[0][:valid], want[0][:valid])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_fused_ce_loss_through_autograd(cuda):
    x, w, labels, g = inputs(256, 128, 768)
    xt, wt = (torch.from_numpy(a).to(cuda, torch.bfloat16).requires_grad_() for a in (x, w))
    lab, gt = torch.from_numpy(labels).to(cuda), torch.from_numpy(g).to(cuda)
    f0, b0 = fc.fwd_launches, fc.bwd_launches
    nll = fc.fused_ce_loss(xt, wt, lab)
    dx, dw = torch.autograd.grad((nll * gt).sum(), (xt, wt))
    with torch.no_grad():
        nll_ng = fc.fused_ce_loss(xt, wt, lab)
    assert (fc.fwd_launches, fc.bwd_launches) == (f0 + 2, b0 + 1)
    assert torch.equal(nll.detach(), nll_ng)
    ref_nll = fc.fused_ce_fwd_plain(xt.detach(), wt.detach(), lab)[2]
    torch.testing.assert_close(nll.detach(), ref_nll, atol=1e-4, rtol=0)
    # the plain backward on the forward kernel's residual (it repeats
    # bitwise): a plain residual may round an element the other way
    lg, lse, _ = fc.fused_ce_fwd(xt.detach(), wt.detach(), lab)
    ref_dx, ref_dw = fc.fused_ce_bwd_plain(lg, lse, lab, gt, xt.detach(), wt.detach())
    _close16(dx, ref_dx, torch.bfloat16)
    _close16(dw, ref_dw, torch.bfloat16)
    with pytest.raises(ValueError):  # mixed dtypes raise, no plain fallback
        fc.fused_ce_loss(xt.detach(), wt.detach().float(), lab)
    with pytest.raises(ValueError):  # a non-contiguous weight raises
        fc.fused_ce_loss(xt.detach(), torch.empty(128, 768, device=cuda,
                                                  dtype=torch.bfloat16).t(), lab)
