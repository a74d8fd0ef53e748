"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the same seeded numpy inputs.

* ``route_topk``: the experts bitwise (a row of all-equal logits included:
  ``lax.top_k`` puts the lower expert first on a tie), the weights at
  rtol 1e-6, the aux loss at rtol 1e-6.
* ``dispatch_indices``: ``buf_pos`` and ``keep`` bitwise.
* ``moe_ffn`` with and without the shared expert, SiLU and GELU (the tanh
  approximation, ``jax.nn.gelu``'s default): the output at rtol 1e-5 /
  atol 1e-5, the aux loss at rtol 1e-6, the gradients of every input at
  rtol 1e-4 / atol 1e-5.
* The reference's scratch row: dropped assignments scatter zeros into
  buffer row E*C - 1, which is also rank C-1 of expert E-1, and XLA's last
  write wins.  With 2 experts, top-1, 40 tokens and capacity 16, tokens
  0-15 routed to expert 1 and the rest to expert 0, token 15's output is
  exactly 0 in both packages, and so is its gradient.
* A hypothesis sweep over (T, E, k, capacity_factor) holds dispatch
  bitwise and the output and aux loss at the tolerances above.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.models import moe as jm  # noqa: E402
from repro.models.common import Dist  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

FE = 6  # d_ff_expert


def _cfgs(E, k, cf=1.25, shared=0):
    kw = dict(n_experts=E, top_k=k, d_ff_expert=FE, shared_d_ff=shared,
              capacity_factor=cf)
    return jm.MoEConfig(**kw), tm.MoEConfig(**kw)


def _weights(rng, d, E, shared=0, router=None):
    w = {"router": (router if router is not None else
                    rng.standard_normal((d, E)).astype(np.float32)),
         "we1": (rng.standard_normal((E, d, FE)) * 0.3).astype(np.float32),
         "we3": (rng.standard_normal((E, d, FE)) * 0.3).astype(np.float32),
         "we2": (rng.standard_normal((E, FE, d)) * 0.3).astype(np.float32)}
    if shared:
        w["ws1"] = (rng.standard_normal((d, shared)) * 0.3).astype(np.float32)
        w["ws3"] = (rng.standard_normal((d, shared)) * 0.3).astype(np.float32)
        w["ws2"] = (rng.standard_normal((shared, d)) * 0.3).astype(np.float32)
    return w


def test_route_topk_matches_jax_with_tied_rows():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((24, 8)).astype(np.float32)
    logits[3] = 0.0  # every expert tied: the lowest k win, in order
    logits[7] = 1.5
    logits[9, [2, 5, 6]] = 4.0  # a three-way tie at the top
    jc, tc = _cfgs(8, 3)
    jw, je, jaux = jm.route_topk(jnp.asarray(logits), jc)
    tw, te, taux = tm.route_topk(torch.from_numpy(logits), tc)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[3].tolist() == [0, 1, 2] and te[9].tolist() == [2, 5, 6]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("T,E,k,cf", [(40, 4, 2, 1.0), (64, 8, 2, 0.25),
                                      (33, 3, 3, 2.0), (100, 60, 4, 1.25)])
def test_dispatch_indices_match_jax_bitwise(T, E, k, cf):
    rng = np.random.default_rng(T + E)
    experts = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    experts[: T // 3] = np.arange(k)  # a crowded expert group overflows
    jc, tc = _cfgs(E, k, cf)
    cap = jc.capacity(T)
    assert tc.capacity(T) == cap
    jpos, jkeep = jm.dispatch_indices(jnp.asarray(experts), jc, cap)
    tpos, tkeep = tm.dispatch_indices(torch.from_numpy(experts).long(), tc,
                                      cap)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


def _both(x, w, E, k, cf, shared, act, cot=None):
    """(JAX out, aux, grads), (port out, aux, grads) of sum(out * cot) +
    aux with respect to x and every weight."""
    jc, tc = _cfgs(E, k, cf, shared)
    cot = np.ones((x.shape[0], x.shape[1]), np.float32) if cot is None else cot

    def jloss(x, w):
        out, aux = jm.moe_ffn(x, w, jc, Dist.none(), act)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in w.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {n: torch.from_numpy(v).requires_grad_(True) for n, v in w.items()}
    tout, taux = tm.moe_ffn(tx, tw, tc, None, act)
    (torch.sum(tout * torch.from_numpy(cot)) + taux).backward()
    tg = (tx.grad.numpy(), {n: v.grad.numpy() for n, v in tw.items()})
    return ((np.asarray(jout), float(jaux), (np.asarray(jg[0]), {
        n: np.asarray(v) for n, v in jg[1].items()})),
        (tout.detach().numpy(), taux.item(), tg))


@pytest.mark.parametrize("shared", [0, 16], ids=["routed", "shared"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_ffn_and_gradients_match_jax(shared, act):
    rng = np.random.default_rng(7 + shared)
    T, d, E, k = 48, 8, 6, 2
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = _weights(rng, d, E, shared)
    cot = rng.standard_normal((T, d)).astype(np.float32)
    (jout, jaux, jg), (tout, taux, tg) = _both(x, w, E, k, 0.5, shared, act,
                                               cot)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-4, atol=1e-5)
    for n in w:
        np.testing.assert_allclose(tg[1][n], jg[1][n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_act_fn_gelu_is_the_tanh_approximation():
    from repro.models.common import act_fn as jax_act
    from repro_torch.models.common import act_fn

    x = np.linspace(-6, 6, 1001).astype(np.float32)
    for name in ("relu", "gelu", "silu", "tanh", "sigmoid"):
        np.testing.assert_allclose(act_fn(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_act(name)(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_scratch_row_quirk_is_reproduced():
    """Token 15 holds rank C-1 of expert E-1 = 1, the buffer's last row;
    expert 1's own dropped assignments (none here: 16 tokens fit) and
    expert 0's overflow (tokens 32-39, dropped after it) write zeros
    there last, so its routed output and its gradient are exactly 0 in
    both packages; its neighbours' are not."""
    T, d = 40, 3
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, d)).astype(np.float32)
    x[:16, 0], x[16:, 0] = 5.0, -5.0
    router = np.zeros((d, 2), np.float32)
    router[0] = (-1.0, 1.0)
    w = _weights(rng, d, 2, router=router)
    jc, _ = _cfgs(2, 1, 0.8)
    assert jc.capacity(T) == 16
    cot = rng.standard_normal((T, d)).astype(np.float32)
    (jout, _, jg), (tout, _, tg) = _both(x, w, 2, 1, 0.8, 0, "silu", cot)
    for out in (jout, tout):
        assert np.all(out[15] == 0.0)
        assert np.all(out[14] != 0.0) and np.all(out[16] != 0.0)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    # the gradient of the output alone: token 15's through the expert is
    # masked, and through its gate the expert's output of a zero row is 0
    jc_, tc_ = _cfgs(2, 1, 0.8)
    jgx = jax.grad(lambda x: jnp.sum(jm.moe_ffn(
        x, {n: jnp.asarray(v) for n, v in w.items()}, jc_, Dist.none())[0]
        * cot))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = tm.moe_ffn(tx, {n: torch.from_numpy(v) for n, v in w.items()},
                        tc_)
    (tgx,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), tx)
    assert np.all(np.asarray(jgx)[15] == 0.0)
    assert np.all(tgx.numpy()[15] == 0.0)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-4, atol=1e-5)


def test_scratch_row_kept_when_nothing_is_dropped_after_it():
    """Expert E-1's last slot filled by the final assignment: no drop comes
    after it, so both packages keep its output."""
    T, d = 16, 3
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, d)).astype(np.float32)
    x[:8, 0], x[8:, 0] = -5.0, 5.0  # tokens 8-15 -> expert 1, 8 slots
    router = np.zeros((d, 2), np.float32)
    router[0] = (-1.0, 1.0)
    w = _weights(rng, d, 2, router=router)
    (jout, _, _), (tout, _, _) = _both(x, w, 2, 1, 1.0, 0, "silu")
    assert np.all(jout[15] != 0.0) and np.all(tout[15] != 0.0)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(T=st.integers(1, 48), E=st.integers(2, 9), k=st.integers(1, 3),
       cf=st.sampled_from([0.1, 0.5, 1.0, 1.25, 2.0]),
       seed=st.integers(0, 2**16))
def test_moe_sweep_matches_jax(T, E, k, cf, seed):
    k = min(k, E)
    rng = np.random.default_rng(seed)
    d = 4
    x = rng.standard_normal((T, d)).astype(np.float32)
    x[rng.random(T) < 0.2] = 0.0  # zero tokens: every logit tied
    w = _weights(rng, d, E)
    jc, tc = _cfgs(E, k, cf)
    jw, je, _ = jm.route_topk(jnp.asarray(x @ w["router"]), jc)
    tw, te, _ = tm.route_topk(torch.from_numpy(x) @ torch.from_numpy(
        w["router"]), tc)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    cap = jc.capacity(T)
    jpos, jkeep = jm.dispatch_indices(je, jc, cap)
    tpos, tkeep = tm.dispatch_indices(te, tc, cap)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    jout, jaux = jm.moe_ffn(jnp.asarray(x), {n: jnp.asarray(v)
                                            for n, v in w.items()},
                            jc, Dist.none())
    tout, taux = tm.moe_ffn(torch.from_numpy(x),
                            {n: torch.from_numpy(v) for n, v in w.items()},
                            tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
