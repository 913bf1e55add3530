"""The port's flash-attention functions against the JAX package's.

``flash_attention`` and ``flash_attention_block`` run their plain PyTorch
versions for CPU tensors (``_xla_fallback`` and the ring's
``_block_attention``); ``chip_smoke.py`` holds the CUDA kernels against
those same plain versions on the card. Here the plain versions meet the JAX
package's Pallas kernels run by the Pallas interpreter (``interpret=True``),
on inputs made with numpy from a seed. Tolerances: rtol 2e-4 / atol 2e-5 in
float32 (the JAX suite's own for the sharded attention), 5e-2 / 2e-2 for
bfloat16 inputs, 2e-3 / 2e-4 for gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synapseml_tpu.ops import attention_kernel as jak
from synapseml_tpu.parallel import ring_attention as jra
from synapseml_tpu_torch.ops import attention_kernel as tak
from synapseml_tpu_torch.parallel import ring_attention as tra

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL, BF16_ATOL = 5e-2, 2e-2
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


def _qkv(seed=0, b=2, s=48, h=2, d=32, s_k=None):
    rng = np.random.default_rng(seed)
    s_k = s_k or s
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s_k, h, d)).astype(np.float32),
            rng.normal(size=(b, s_k, h, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _state(b, sq, h, d, seed):
    """A carried state that one earlier step produced: finite m, l > 0."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(b, h, sq)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, size=(b, h, sq)).astype(np.float32)
    o = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return m, l, o


def _empty_state(b, sq, h, d):
    return (np.full((b, h, sq), -np.inf, np.float32),
            np.zeros((b, h, sq), np.float32),
            np.zeros((b, sq, h, d), np.float32))


@pytest.mark.parametrize("s,s_k,causal,scale", [
    (48, None, False, None), (48, None, True, None),
    (37, 53, False, None), (37, 53, True, None),      # non-divisible lengths
    (32, 64, False, None), (32, 64, True, None),      # cross-attention
    (48, None, False, 0.5),
])
def test_flash_attention_plain_matches_pallas(s, s_k, causal, scale):
    q, k, v = _qkv(s=s, s_k=s_k)
    want = np.asarray(jak.flash_attention(q, k, v, causal=causal,
                                          scale=scale, block_q=16,
                                          block_k=16, interpret=True))
    got = tak.flash_attention(*_t(q, k, v), causal=causal, scale=scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_heads_plain_match_pallas(d, causal):
    """Head dims above 64 (the kernel pads 65..128 to 128): the plain
    versions against the Pallas interpreter, both functions."""
    q, k, v = _qkv(seed=d, s=40, s_k=56, d=d)
    want = np.asarray(jak.flash_attention(q, k, v, causal=causal, block_q=8,
                                          block_k=8, interpret=True))
    got = tak.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    state = _state(2, 40, 2, d, d + 1)
    want = jak.flash_attention_block(q, k, v, *state, 30, 10, causal=causal,
                                     block_q=8, block_k=8, interpret=True)
    got = tak.flash_attention_block(*_t(q, k, v, *state), 30, 10,
                                    causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_flash_attention_bf16_inputs():
    q, k, v = _qkv()
    want = np.asarray(jak.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), block_q=16,
        block_k=16, interpret=True)).astype(np.float32)
    got = tak.flash_attention(*(x.to(torch.bfloat16) for x in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_near_prime_length_takes_the_reference_einsum():
    q, k, v = _qkv(s=7, s_k=7, d=16)              # no block divisor >= 8
    assert tak.divisor_block(7, 128) == 0
    want = np.asarray(jra.attention_reference(q, k, v, causal=True))
    got = tak.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,want_block,expected", [
    (4096, 512, 512), (1000, 512, 500), (4097, 128, 17), (97, 128, 97),
    (13, 128, 13), (7, 128, 0),
])
def test_divisor_block_matches_reference(s, want_block, expected):
    assert tak.divisor_block(s, want_block) == expected
    assert jak.divisor_block(s, want_block) == expected


@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_plain_matches_pallas(causal):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    k = rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
    for state in (_empty_state(2, 24, 2, 16), _state(2, 24, 2, 16, 5)):
        mk, lk, ok = (np.asarray(a) for a in jak.flash_attention_block(
            q, k, v, *state, q_offset=8, k_offset=0, causal=causal,
            scale=0.25, block_q=8, block_k=8, interpret=True))
        mp, lp, op = (a.numpy() for a in tak.flash_attention_block(
            *_t(q, k, v, *state), 8, 0, causal=causal, scale=0.25))
        # the plain version keeps -inf where no key reached a row; the
        # kernels keep their finite sentinel: equal through _finalize
        fin = np.isfinite(mp)
        np.testing.assert_allclose(mp[fin], mk[fin], rtol=RTOL, atol=ATOL)
        assert (mk[~fin] == tak._NEG_INF).all()
        np.testing.assert_allclose(lp, lk, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(op, ok, rtol=RTOL, atol=ATOL)


def test_flash_block_bf16_inputs():
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
               for _ in range(3))
    state = _state(2, 16, 2, 16, 7)
    mk, lk, ok = (np.asarray(a) for a in jak.flash_attention_block(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), *state,
        q_offset=16, k_offset=0, causal=True, block_q=8, block_k=8,
        interpret=True))
    mp, lp, op = (a.numpy() for a in tak.flash_attention_block(
        *(x.to(torch.bfloat16) for x in _t(q, k, v)), *_t(*state), 16, 0,
        causal=True))
    for got, want in ((mp, mk), (lp, lk), (op, ok)):
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_chained_blocks_equal_reference():
    """Folding K/V in two chunks, then finalising, equals full attention —
    the ring's computation on one device."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    m, l, o = _t(*_empty_state(2, 16, 2, 16))
    qt, kt, vt = _t(q, k, v)
    for ks, ke in ((0, 16), (16, 32)):
        m, l, o = tak.flash_attention_block(qt, kt[:, ks:ke], vt[:, ks:ke],
                                            m, l, o, 0, ks, causal=True)
    got = tra._finalize(m, l, o).numpy()
    want = np.asarray(jra.attention_reference(q, k, v, causal=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fully_masked_step_is_identity():
    """A step whose K block lies wholly in the causal future leaves the
    carried state as it was (no NaN), as the JAX package's kernel does."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
               for _ in range(3))
    for state in (_empty_state(2, 8, 2, 16), _state(2, 8, 2, 16, 4)):
        m2, l2, o2 = tak.flash_attention_block(*_t(q, k, v, *state), 0, 100,
                                               causal=True)
        mk, lk, ok = jak.flash_attention_block(
            q, k, v, *state, q_offset=0, k_offset=100, causal=True,
            block_q=8, block_k=8, interpret=True)
        assert not torch.isnan(m2).any()
        np.testing.assert_array_equal(l2.numpy(), state[1])
        np.testing.assert_array_equal(o2.numpy(), state[2])
        np.testing.assert_array_equal(np.asarray(lk), state[1])
        np.testing.assert_array_equal(np.asarray(ok), state[2])


def test_traced_offsets_match():
    """The JAX kernel takes rank-derived traced offsets; the port takes the
    same offsets as Python ints (the rank is one there)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
               for _ in range(3))
    state = _empty_state(2, 16, 2, 16)

    @jax.jit
    def step(koff):
        return jak.flash_attention_block(q, k, v, *state, q_offset=0,
                                         k_offset=koff, causal=True,
                                         block_q=8, block_k=8,
                                         interpret=True)

    _, lk, ok = step(np.int32(8))
    _, lp, op = tak.flash_attention_block(*_t(q, k, v, *state), 0, 8,
                                          causal=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lk), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(op.numpy(), np.asarray(ok), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax(causal):
    q, k, v = _qkv(s=32, d=16)

    def loss(q, k, v):
        return (jak.flash_attention(q, k, v, causal=causal, block_q=16,
                                    block_k=16, interpret=True) ** 2).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    (tak.flash_attention(*xs, causal=causal, block_k=16) ** 2).sum().backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_block_grads_match_jax(causal):
    """The block's recompute backward against ``jax.grad`` of the JAX
    package's differentiable ring step, w.r.t. q, k, v and the state."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
               for _ in range(3))
    state = _state(2, 16, 2, 16, 9)

    def loss(q, k, v, m, l, o):
        m2, l2, o2 = jra._block_attention(q, k, v, m, l, o, 16, 8, causal,
                                          0.25)
        return (o2 ** 2).sum() + (l2 ** 2).sum() + m2.sum()

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(q, k, v, *state)
    xs = [x.requires_grad_() for x in _t(q, k, v, *state)]
    m2, l2, o2 = tak.flash_attention_block(*xs, 16, 8, causal=causal,
                                           scale=0.25)
    ((o2 ** 2).sum() + (l2 ** 2).sum() + m2.sum()).backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_wrappers_check_inputs_and_plain_is_no_launch():
    q, k, v = _t(*_qkv(s=16, d=8))
    with pytest.raises(TypeError):
        tak.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        tak.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        tak.flash_attention(q[0], k, v)
    m, l, o = _t(*_empty_state(2, 16, 2, 8))
    with pytest.raises(ValueError):
        tak.flash_attention_block(q, k, v, m[:, :1], l, o, 0, 0)
    with pytest.raises(TypeError):
        tak.flash_attention_block(q, k, v, m, l, o.double(), 0, 0)
    before = dict(tak.LAUNCHES)
    tak.flash_attention(q, k, v)
    tak.flash_attention_block(q, k, v, m, l, o, 0, 0)
    assert tak.LAUNCHES == before          # the plain versions are no launch


# ---------------------------------------------------------------------------
# The CUDA kernels on the card, against the plain versions on the same
# tensors (float32: rtol 2e-4 / atol 2e-5, the FMA order differs; bf16:
# 8e-3 / 1e-3 on the bf16 output, where both round p to bf16 before the PV
# product against running maxima that differ, and one ulp of the output is
# up to 2^-7 of it).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,s_k,h,d,causal,dtype", [
    (2, 300, 300, 2, 64, False, torch.float32),
    (2, 300, 300, 2, 64, True, torch.float32),
    (1, 37, 53, 3, 8, True, torch.float32),
    (2, 129, 257, 4, 32, False, torch.bfloat16),
    (1, 64, 64, 1, 64, True, torch.float32),
])
def test_cuda_flash_attention_matches_plain(cuda, b, s, s_k, h, d, causal,
                                            dtype):
    q, k, v = (x.to(cuda, dtype) for x in _t(*_qkv(b=b, s=s, s_k=s_k, h=h,
                                                       d=d)))
    before = tak.LAUNCHES["flash_attention"]
    got = tak.flash_attention(q, k, v, causal=causal)
    want = tak._xla_fallback(q, k, v, causal, d ** -0.5, 128)
    torch.cuda.synchronize()
    assert tak.LAUNCHES["flash_attention"] == before + 1
    tol = (RTOL, ATOL) if dtype == torch.float32 else (8e-3, 1e-3)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("q_off,k_off,causal", [
    (64, 0, False), (64, 0, True), (0, 140, True), (200, 100, True),
])
def test_cuda_flash_block_matches_plain(cuda, q_off, k_off, causal):
    rng = np.random.default_rng(q_off + k_off)
    q = rng.normal(size=(2, 140, 2, 64)).astype(np.float32)
    k = rng.normal(size=(2, 128, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, 128, 2, 64)).astype(np.float32)
    for state in (_empty_state(2, 140, 2, 64), _state(2, 140, 2, 64, 1)):
        args = [x.to(cuda) for x in _t(q, k, v, *state)]
        mk, lk, ok = tak.flash_attention_block(*args, q_off, k_off,
                                               causal=causal, scale=0.125)
        mp, lp, op = tra._block_attention(*args, q_off, k_off, causal,
                                          0.125)
        torch.cuda.synchronize()
        fin = torch.isfinite(mp)
        np.testing.assert_allclose(mk[fin].cpu().numpy(),
                                   mp[fin].cpu().numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        # o relative to its row's normaliser: the unnormalised sum carries
        # rounding in proportion to l, not to o
        denom = torch.where(lp > 0, lp, 1.0).transpose(1, 2)[..., None]
        np.testing.assert_allclose((ok / denom).cpu().numpy(),
                                   (op / denom).cpu().numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s,s_k,d,q_off,k_off,causal", [
    (15, 63, 8, 0, 0, True), (16, 64, 32, 0, 0, False),
    (17, 65, 32, 37, 5, True), (127, 129, 64, 0, 0, True),
    (129, 31, 64, 70, 3, True), (128, 200, 32, 300, 101, True),
    (300, 100, 32, 0, 0, True), (257, 33, 32, 10, 3, True),
])
def test_cuda_tile_edges_match_plain(cuda, s, s_k, d, q_off, k_off, causal):
    """Query rows around the warp (16 or 32 rows) and block (128 or 256
    rows) edges, keys around the 32-key tiles, head dims 8, 32 and 64, and
    offsets that divide neither, for both kernels in float32 (the block
    kernel from an empty and a carried state)."""
    q, k, v = (x.to(cuda) for x in _t(*_qkv(seed=s + d, b=1, s=s, s_k=s_k,
                                             h=3, d=d)))
    if q_off == 0 and k_off == 0:
        got = tak.flash_attention(q, k, v, causal=causal)
        want = tak._xla_fallback(q, k, v, causal, d ** -0.5, 128)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
    for state in (_empty_state(1, s, 3, d), _state(1, s, 3, d, 2)):
        m, l, o = (x.to(cuda) for x in _t(*state))
        mk, lk, ok = tak.flash_attention_block(q, k, v, m, l, o, q_off,
                                               k_off, causal=causal)
        mp, lp, op = tra._block_attention(q, k, v, m, l, o, q_off, k_off,
                                          causal, d ** -0.5)
        torch.cuda.synchronize()
        fin = torch.isfinite(mp)
        np.testing.assert_allclose(mk[fin].cpu().numpy(),
                                   mp[fin].cpu().numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        denom = torch.where(lp > 0, lp, 1.0).transpose(1, 2)[..., None]
        np.testing.assert_allclose((ok / denom).cpu().numpy(),
                                   (op / denom).cpu().numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.cuda
def test_cuda_flash_block_future_step_is_bit_identical(cuda):
    """A step wholly in the causal future leaves l and o bit-identical,
    also where only some warps of a block see no key."""
    q, k, v = (x.to(cuda) for x in _t(*_qkv(seed=9, b=1, s=140, s_k=64,
                                             h=2, d=32)))
    m, l, o = (x.to(cuda) for x in _t(*_state(1, 140, 2, 32, 3)))
    _, l2, o2 = tak.flash_attention_block(q, k, v, m, l, o, 0, 40,
                                          causal=True)
    torch.cuda.synchronize()
    # rows 0..39 see no key: their l and o must not move at all
    assert torch.equal(l2[:, :, :40], l[:, :, :40])
    assert torch.equal(o2[:, :40], o[:, :40])


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = (x.to(cuda) for x in _t(*_qkv(s=16, d=8)))
    m, l, o = _t(*_empty_state(2, 16, 2, 8))
    before = dict(tak.LAUNCHES)
    with pytest.raises(ValueError):
        tak.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        tak.flash_attention_block(q, k, v, m, l.to(cuda), o.to(cuda), 0, 0)
    assert tak.LAUNCHES == before
    # a head above 128 launches the wide kernel and matches the plain version
    wq, wk, wv = (x.to(cuda) for x in _t(*_qkv(seed=5, b=1, s=24, h=1,
                                               d=256)))
    got = tak.flash_attention(wq, wk, wv)
    want = tak._xla_fallback(wq, wk, wv, False, 256 ** -0.5, 128)
    torch.cuda.synchronize()
    assert tak.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 128, 192, 256, 2304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_wide_heads_match_plain(cuda, d, dtype, causal):
    """D = 96 and 128 (the DP = 128 instantiation: Q unsplit, 16-key tiles)
    and the wide kernel at D = 192 and 256 (output rows in shared memory)
    and 2304 (in the float32 scratch buffer) for both kernels, rows and keys
    around the 16-row warps and blocks, 128-row blocks and 16- and 64-key
    tiles. bf16 ``flash_attention`` is compared without a causal
    mask: rows that see a handful of keys keep the bf16 rounding of p
    undiluted, beyond the bf16 tolerance, in any D; the bf16 carried
    state's o / l is held to its rounding bound."""
    q, k, v = (x.to(cuda, dtype) for x in _t(*_qkv(seed=d, b=2, s=145,
                                                       s_k=130, h=3, d=d)))
    tol = (RTOL, ATOL) if dtype == torch.float32 else (8e-3, 1e-3)
    if dtype == torch.float32 or not causal:
        got = tak.flash_attention(q, k, v, causal=causal)
        want = tak._xla_fallback(q, k, v, causal, d ** -0.5, 128)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol[0],
                                   atol=tol[1])
    m, l, o = (x.to(cuda) for x in _t(*_state(2, 145, 3, d, 4)))
    mk, lk, ok = tak.flash_attention_block(q, k, v, m, l, o, 40, 17,
                                           causal=causal)
    mp, lp, op = tra._block_attention(q, k, v, m, l, o, 40, 17, causal,
                                      d ** -0.5)
    torch.cuda.synchronize()
    np.testing.assert_allclose(mk.cpu().numpy(), mp.cpu().numpy(),
                               rtol=tol[0], atol=tol[1])
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(),
                               rtol=tol[0], atol=tol[1])
    denom = torch.where(lp > 0, lp, 1.0).transpose(1, 2)[..., None]
    if dtype == torch.float32:
        np.testing.assert_allclose((ok / denom).cpu().numpy(),
                                   (op / denom).cpu().numpy(), rtol=tol[0],
                                   atol=tol[1])
    else:
        # bf16: each side rounds every p to bf16 against its own running
        # maximum, so o / l differ by at most 2^-8 max |v| (chip_smoke.py
        # bf16_o_bound); the elementwise bf16 tolerance fails on entries
        # near zero at any head dim
        gap = float((ok / denom - op / denom).abs().max())
        assert gap <= 2.0 ** -8 * float(v.float().abs().max())
