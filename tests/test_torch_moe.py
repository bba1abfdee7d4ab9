"""The port's Mixture-of-Experts against ``paddle_tpu.incubate`` on the CPU
(where the routing kernel's wrappers run their plain versions), the same
seeded numpy inputs and weights on both sides:

* the gates (``NaiveGate``, ``GShardGate``, ``SwitchGate``) at top-1 and
  top-2, with capacity overflow (dropped routes) and tied logits (all-zero
  gate weights: the port's picks must be ``jax.lax.top_k``'s);
* ``MoELayer``: output, ``l_aux`` and the gradients of x, the gate and
  every expert weight, fp32 and O2;
* ``fused_ec_moe`` and ``FusedEcMoe`` with gelu and relu, fp32 and bf16,
  T < E (capacity 1), tokens picked by several experts and by none;
* ``FusedMoELayer`` raising ``TypeError`` in both packages, the refusals,
  the converter round trip;
* K9's plain versions against autograd of an index-free (one-hot)
  reference, K6's bias period against a per-expert loop, the autograd
  functions through the kernel path (each launch done by its plain
  version), and an MoE step under ``jit.capture_step`` on a CPU model.

Tolerances. fp32: outputs within rtol 1e-5 at the tensor's scale
(``1e-5 * max|ref|``): the two differ by summation order in the products
and the softmax only; gradients within 1e-4 of each tensor's largest
element. bf16 (the expert-choice MoE): the routing is bit-equal (the
softmax is rounded step by step as XLA rounds it) and ReLU outputs come
out bit-equal; GELU rounds once in the port and after each primitive in
the JAX package, so outputs are held within 2^-6 of the tensor's scale
(two bf16 ulps) and gradients within 2^-4 of each tensor's largest
element (the flips compound through two products). O2 (MoELayer): the
same bf16 bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.incubate import nn_functional as JF
from paddle_tpu.nn import functional as JNF
from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.convert import state_dict_from_paddle_tpu
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate import nn_functional as TF
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops import bias_act as ba
from paddle_tpu_torch.ops import moe as K9
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

M, E, HID = 32, 4, 48
RTOL, GRAD_ATOL = 1e-5, 1e-4
BF16_OUT, BF16_GRAD = 2.0 ** -6, 2.0 ** -4


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jnp(t):
    return np.asarray(t._data.astype(jnp.float32))


def _close(got, want, what=""):
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                               err_msg=what)


def _grad_close(got, want, what, bound=None):
    lim = (bound or GRAD_ATOL) * max(float(np.abs(want).max(initial=0.0)),
                                    1e-12)
    assert np.abs(got - want).max() <= lim, (what, np.abs(got - want).max(),
                                            lim)


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

GATES = {"naive": (jmoe.NaiveGate, tmoe.NaiveGate),
         "gshard": (jmoe.GShardGate, tmoe.GShardGate),
         "switch": (jmoe.SwitchGate, tmoe.SwitchGate)}
# (tokens, capacity factor, gate weight scale): random picks within
# capacity, overflow (capacity 4-8 for 64 tokens), all-zero weights (ties)
GATE_CASES = {"random": (16, 1.5, 1.0), "overflow": (64, 0.25, 1.0),
              "tied": (64, 0.5, 0.0)}


def _gate_pair(kind, k, cf, wscale, seed=1):
    w = _np(seed, M, E, scale=wscale / np.sqrt(M))
    jg = GATES[kind][0](M, E, top_k=k, capacity_factor=cf)
    jg.set_state_dict({"gate_proj.weight": paddle.to_tensor(w)})
    tg = GATES[kind][1](M, E, top_k=k, capacity_factor=cf, device="cpu")
    tg.load_state_dict(state_dict_from_paddle_tpu({"gate_proj.weight": w}))
    return jg, tg


@pytest.mark.parametrize("case", sorted(GATE_CASES))
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind", sorted(GATES))
def test_gate_matches_jax(kind, k, case):
    s, cf, wscale = GATE_CASES[case]
    jg, tg = _gate_pair(kind, k, cf, wscale)
    x = _np(2, s, M)
    jd, jc, ja = jg(paddle.to_tensor(x))
    with torch.no_grad():
        td, tc, ta = tg(torch.from_numpy(x))
    jd, jc = _jnp(jd), _jnp(jc)
    assert td.shape == jd.shape == (s, E, tg.capacity(s))
    np.testing.assert_array_equal(td.numpy(), jd)   # the same routes kept
    _close(tc.numpy(), jc, "combine")
    _close(ta.numpy(), _jnp(ja), "aux")
    assert tg.l_aux is ta
    kept, routed = jd.sum(), s * k
    if case == "random":
        assert kept == routed
    else:
        assert kept < routed        # overflow dropped
    if case == "tied":
        # every token's picks are experts 0..k-1, as jax.lax.top_k's
        _, want = jax.lax.top_k(jnp.full((s, E), 1.0 / E), k)
        _, got = tmoe.top_k(torch.full((s, E), 1.0 / E), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert set(np.nonzero(jd.sum(axis=(0, 2)))[0]) == set(range(k))


def test_switch_gate_from_a_dict_takes_capacity_factor_1p5():
    # the reference's quirk, ported: the dict path gives every type 1.5
    experts = [torch.nn.Identity() for _ in range(E)]
    layer = tmoe.MoELayer(M, experts, gate={"type": "switch"}, device="cpu")
    jl = jmoe.MoELayer(M, [jnn.Linear(M, M) for _ in range(E)],
                       gate={"type": "switch"})
    assert layer.gate.capacity_factor == jl.gate.capacity_factor == 1.5
    assert layer.gate.top_k == jl.gate.top_k == 2


# ---------------------------------------------------------------------------
# MoELayer
# ---------------------------------------------------------------------------

class JExpert(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(M, HID)
        self.fc2 = jnn.Linear(HID, M)

    def forward(self, x):
        return self.fc2(JNF.gelu(self.fc1(x)))


class TExpert(torch.nn.Module):
    def __init__(self, device="cpu"):
        super().__init__()
        self.fc1 = Linear(M, HID, device=device)
        self.fc2 = Linear(HID, M, device=device)

    def forward(self, x):
        h = nn_ops.linear(x, self.fc1.weight, self.fc1.bias,
                          activation="gelu")
        return self.fc2(h)


def _moe_state(seed, k):
    st = {"gate.gate_proj.weight": _np(seed, M, E, scale=1 / np.sqrt(M))}
    for i in range(E):
        st[f"experts.{i}.fc1.weight"] = _np(seed + 10 + i, M, HID,
                                            scale=1 / np.sqrt(M))
        st[f"experts.{i}.fc1.bias"] = _np(seed + 20 + i, HID, scale=0.1)
        st[f"experts.{i}.fc2.weight"] = _np(seed + 30 + i, HID, M,
                                            scale=1 / np.sqrt(HID))
        st[f"experts.{i}.fc2.bias"] = _np(seed + 40 + i, M, scale=0.1)
    return st


def _moe_pair(k, gate_type, cf, seed=3):
    st = _moe_state(seed, k)
    gate = {"type": gate_type, "top_k": k, "capacity_factor": cf}
    jl = jmoe.MoELayer(M, [JExpert() for _ in range(E)], gate=dict(gate))
    jl.set_state_dict({n: paddle.to_tensor(v) for n, v in st.items()})
    tl = tmoe.MoELayer(M, [TExpert() for _ in range(E)], gate=dict(gate),
                       device="cpu")
    tl.load_state_dict(state_dict_from_paddle_tpu(st), strict=True)
    return jl, tl, st


def _moe_run(jl, tl, x, w, aux_w, o2=False):
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    tx = torch.from_numpy(x.copy()).requires_grad_()
    if o2:
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jo = jl(jx)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            to = tl(tx)
    else:
        jo, to = jl(jx), tl(tx)
    ((jo.astype("float32") * paddle.to_tensor(w)).sum()
     + jl.l_aux * aux_w).backward()
    ((to.float() * torch.from_numpy(w)).sum() + tl.l_aux * aux_w).backward()
    jg = {n: np.asarray(p.grad._data, np.float32)
          for n, p in jl.named_parameters() if p.grad is not None}
    tg = {n: p.grad.float().numpy() for n, p in tl.named_parameters()
          if p.grad is not None}
    jg["x"], tg["x"] = np.asarray(jx.grad._data, np.float32), \
        tx.grad.float().numpy()
    return _jnp(jo), to.detach().float().numpy(), _jnp(jl.l_aux), \
        tl.l_aux.detach().numpy(), jg, tg


@pytest.mark.parametrize("gate_type,k,cf", [
    ("gshard", 2, 1.5), ("gshard", 2, 0.5), ("naive", 1, 1.5),
    ("switch", 1, 0.5), ("naive", 2, 1.0)])
def test_moe_layer_matches_jax(gate_type, k, cf):
    jl, tl, _ = _moe_pair(k, gate_type, cf)
    x = _np(4, 2, 24, M)
    w = _np(5, 2, 24, M)
    jo, to, ja, ta, jg, tg = _moe_run(jl, tl, x, w, 0.7)
    assert to.shape == jo.shape == x.shape
    _close(to, jo, "out")
    _close(ta, ja, "aux")
    assert set(tg) == set(jg)
    assert {f"experts.{i}.fc1.weight" for i in range(E)} <= set(tg)
    for n, g in jg.items():
        _grad_close(tg[n], g, n)


def test_moe_layer_o2_matches_jax():
    jl, tl, _ = _moe_pair(2, "gshard", 1.0)
    x = _np(6, 2, 16, M)
    w = _np(7, 2, 16, M)
    jo, to, ja, ta, jg, tg = _moe_run(jl, tl, x, w, 0.5, o2=True)
    lim = BF16_OUT * (np.abs(jo) + np.abs(jo).max())
    assert (np.abs(to - jo) <= lim).all()
    _close(ta, ja, "aux")
    assert set(tg) == set(jg)
    for n, g in jg.items():
        _grad_close(tg[n], g, n, BF16_GRAD)


class _DenseGate(torch.nn.Module):
    """A gate object without ``route``: only the dense contract."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner(x)


def test_moe_layer_with_a_dense_gate_object():
    # a gate without ``route`` keeps the reference's dense contract and
    # takes the same index kernels: outputs and gradients as JAX's, with
    # dropped routes and empty slots (cf 0.75)
    jl, tl, st = _moe_pair(2, "gshard", 0.75)
    tl2 = tmoe.MoELayer(M, tl.experts, gate=_DenseGate(tl.gate))
    assert not hasattr(tl2.gate, "route")
    x = _np(8, 2, 24, M)
    jo, to, ja, ta, jg, tg = _moe_run(jl, tl2, x, _np(9, 2, 24, M), 0.7)
    _close(to, jo, "out")
    _close(ta, ja, "aux")
    tg = {n.replace("gate.inner.", "gate."): g for n, g in tg.items()}
    assert set(tg) == set(jg)
    for n, g in jg.items():
        _grad_close(tg[n], g, n)
    with torch.no_grad():   # two routes a token: the sum's order is moot
        assert torch.equal(tl2(torch.from_numpy(x)), tl(torch.from_numpy(x)))


def test_fused_moe_layer_raises_the_reference_type_error():
    with pytest.raises(TypeError, match="experts"):
        jinn.FusedMoELayer(M, HID, E)
    with pytest.raises(TypeError, match="experts"):
        tinn.FusedMoELayer(M, HID, E)


def test_converter_round_trip_keeps_keys_and_outputs():
    jl, tl, st = _moe_pair(2, "gshard", 1.5)
    back = {n: t.detach().numpy() for n, t in tl.state_dict().items()}
    assert set(back) == set(st)
    jl2 = jmoe.MoELayer(M, [JExpert() for _ in range(E)])
    jl2.set_state_dict({n: paddle.to_tensor(v) for n, v in back.items()})
    x = _np(9, 20, M)
    np.testing.assert_array_equal(_jnp(jl2(paddle.to_tensor(x))),
                                  _jnp(jl(paddle.to_tensor(x))))
    ec = _ec_state(11, HID)
    je = jinn.FusedEcMoe(M, HID, E)
    je.set_state_dict({n: paddle.to_tensor(v) for n, v in ec.items()})
    te = tinn.FusedEcMoe(M, HID, E, device="cpu")
    te.load_state_dict(state_dict_from_paddle_tpu(
        {n: np.asarray(t._data) for n, t in je.state_dict().items()}),
        strict=True)
    for n, t in te.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ec[n])


# ---------------------------------------------------------------------------
# the expert-choice MoE
# ---------------------------------------------------------------------------

def _ec_state(seed, inter):
    return {"w0": _np(seed, E, M, inter, scale=1 / np.sqrt(M)),
            "b0": _np(seed + 1, E, 1, inter, scale=0.1),
            "w1": _np(seed + 2, E, inter, M, scale=1 / np.sqrt(inter)),
            "b1": _np(seed + 3, E, 1, M, scale=0.1)}


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ec_run(act, dtype, b, s, seed=12, layer=False):
    st = _ec_state(seed, HID)
    x = _np(seed + 5, b, s, M)
    g = _np(seed + 6, b, s, E, scale=2.0)
    w = _np(seed + 7, b, s, M)
    names = ("x", "gate", "w0", "b0", "w1", "b1")
    arrs = [x, g, st["w0"], st["b0"], st["w1"], st["b1"]]
    jl = [paddle.to_tensor(np.asarray(jnp.asarray(a).astype(JDT[dtype])))
          for a in arrs]
    for t in jl:
        t.stop_gradient = False
    tl = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]
    if layer:
        je = jinn.FusedEcMoe(M, HID, E, act_type=act)
        je.set_state_dict(dict(zip(names[2:], jl[2:])))
        te = tinn.FusedEcMoe(M, HID, E, act_type=act, device="cpu",
                             dtype=dtype)
        te.load_state_dict(state_dict_from_paddle_tpu(
            {n: np.asarray(t._data) for n, t in zip(names[2:], jl[2:])}))
        jo, to = je(jl[0], jl[1]), te(tl[0], tl[1])
        jleaves = jl[:2] + [je.w0, je.b0, je.w1, je.b1]
        tleaves = tl[:2] + [te.w0, te.b0, te.w1, te.b1]
    else:
        jo = JF.fused_ec_moe(*jl, act_type=act)
        to = TF.fused_ec_moe(*tl, act_type=act)
        jleaves, tleaves = jl, tl
    (jo.astype("float32") * paddle.to_tensor(w)).sum().backward()
    (to.float() * torch.from_numpy(w)).sum().backward()
    jg = {n: np.asarray(t.grad._data.astype(jnp.float32))
          for n, t in zip(names, jleaves)}
    tg = {n: t.grad.float().numpy() for n, t in zip(names, tleaves)}
    return _jnp(jo), to.detach().float().numpy(), jg, tg, g


def _ec_check(jo, to, jg, tg, dtype, act):
    assert to.shape == jo.shape
    if dtype == torch.float32:
        _close(to, jo, "out")
        for n, g in jg.items():
            _grad_close(tg[n], g, n)
        return
    if act == "relu":
        np.testing.assert_array_equal(to, jo)
    lim = BF16_OUT * max(float(np.abs(jo).max()), 1e-12)
    assert np.abs(to - jo).max() <= lim
    for n, g in jg.items():
        _grad_close(tg[n], g, n, BF16_GRAD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe_matches_jax(act, dtype):
    jo, to, jg, tg, g = _ec_run(act, dtype, 2, 16)
    _ec_check(jo, to, jg, tg, dtype, act)
    # the picks hold a token several experts took and one no expert took
    probs = TF._softmax_rounded(torch.from_numpy(g).to(dtype).reshape(
        32, E))
    _, sel = tmoe.top_k(probs.t(), 32 // E)
    hits = np.bincount(sel.reshape(-1).numpy(), minlength=32)
    assert hits.max() >= 2 and (hits == 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_ec_moe_fewer_tokens_than_experts(dtype):
    # T = 3 < E = 4: capacity 1, every expert takes its single best token
    jo, to, jg, tg, _ = _ec_run("gelu", dtype, 1, 3, seed=30)
    _ec_check(jo, to, jg, tg, dtype, "gelu")


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe_layer_matches_jax(act):
    jo, to, jg, tg, _ = _ec_run(act, torch.float32, 2, 16, seed=40,
                                layer=True)
    _ec_check(jo, to, jg, tg, torch.float32, act)


def test_fused_ec_moe_o2_casts_as_the_reference():
    st = _ec_state(50, HID)
    x, g = _np(55, 2, 16, M), _np(56, 2, 16, E)
    je = jinn.FusedEcMoe(M, HID, E)
    je.set_state_dict({n: paddle.to_tensor(v) for n, v in st.items()})
    te = tinn.FusedEcMoe(M, HID, E, device="cpu")
    te.load_state_dict(state_dict_from_paddle_tpu(st))
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        jo = je(paddle.to_tensor(x), paddle.to_tensor(g))
    with amp.auto_cast(level="O2", dtype="bfloat16"), torch.no_grad():
        to = te(torch.from_numpy(x), torch.from_numpy(g))
    assert to.dtype == torch.bfloat16 and str(jo._data.dtype) == "bfloat16"
    jo = _jnp(jo)
    assert np.abs(to.float().numpy() - jo).max() <= BF16_OUT * np.abs(
        jo).max()


@pytest.mark.parametrize("call", ["functional", "layer"])
@pytest.mark.parametrize("bad", ["act", "weight_attr", "bias_attr"])
def test_ec_moe_refusals_raise_the_same_types(call, bad):
    st = _ec_state(60, HID)
    x, g = _np(61, 1, 4, M), _np(62, 1, 4, E)

    def run(mod_f, mod_nn, to, kw):
        if call == "functional":
            if bad != "act":
                return None
            return mod_f.fused_ec_moe(
                to(x), to(g), *[to(st[n]) for n in ("w0", "b0", "w1", "b1")],
                act_type="silu")
        return mod_nn.FusedEcMoe(M, HID, E, **kw)
    kw = {"act": {"act_type": "silu"}, "weight_attr": {"weight_attr": False},
          "bias_attr": {"bias_attr": False}}[bad]
    got = []
    for mod_f, mod_nn, to, extra in (
            (JF, jinn, paddle.to_tensor, {}),
            (TF, tinn, torch.from_numpy, {"device": "cpu"})):
        try:
            run(mod_f, mod_nn, to, {**kw, **extra} if call == "layer"
                else kw)
            got.append(None)
        except Exception as e:   # noqa: BLE001 - the type is compared
            got.append(type(e))
    assert got[0] == got[1]
    assert got[0] is (ValueError if call == "layer" or bad == "act"
                      else None)


# ---------------------------------------------------------------------------
# K9's plain versions and autograd functions
# ---------------------------------------------------------------------------

def _token_choice(s, k, cap, seed):
    rng = np.random.default_rng(seed)
    expert = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                        for _ in range(s)]))
    onehot = torch.nn.functional.one_hot(expert.t().reshape(-1), E)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1).reshape(
        k, s).t()
    keep = pos < cap
    return K9.token_choice_routes(expert, pos, keep, E, cap), expert, pos, \
        keep


def _onehot_dispatch(routes):
    """(S, E C) with 1 where token s fills slot e c (index-free)."""
    d = torch.zeros(routes.tokens, routes.slots)
    for s in range(routes.slots):
        r = int(routes.slot_route[s])
        if r >= 0:
            d[int(routes.route_token[r]), s] = 1.0
    return d


@pytest.mark.parametrize("kind", ["token_choice", "expert_choice",
                                  "dense"])
def test_k9_plain_versions_match_autograd_of_one_hot_products(kind):
    if kind == "token_choice":
        routes, *_ = _token_choice(24, 2, 10, seed=70)
    elif kind == "dense":   # a dense gate's tensors, dropped and empty slots
        tc, *_ = _token_choice(24, 2, 12, seed=77)
        gates = torch.from_numpy(np.abs(_np(78, tc.slot.numel())))
        disp, comb = tmoe._dense(tc, gates)
        routes, dg = K9.dense_routes(disp, comb)
        assert int((routes.slot_route < 0).sum()) > 0
        assert int((tc.slot < 0).sum()) > 0
        # each live slot keeps its token and its gate
        live = routes.slot >= 0
        s_of = routes.slot.long()[live]
        assert torch.equal(dg[live], comb.reshape(24, -1)[
            routes.route_token.long()[live], s_of])
        assert torch.equal(routes.route_token.long()[live],
                           disp.reshape(24, -1)[:, s_of].argmax(0))
    else:
        probs = torch.softmax(torch.from_numpy(_np(71, 24, E)), -1)
        _, sel = tmoe.top_k(probs.t(), 6)
        routes, perm = K9.expert_choice_routes(sel, 24)
    d = _onehot_dispatch(routes)
    nr = routes.slot.numel()
    x = torch.from_numpy(_np(72, routes.tokens, M)).requires_grad_()
    y = torch.from_numpy(_np(73, routes.slots, M)).requires_grad_()
    g = torch.from_numpy(np.abs(_np(74, nr))).requires_grad_()
    # index-free references
    gs = torch.zeros(routes.tokens, routes.slots)
    live = routes.slot >= 0
    gs = gs.index_put((routes.route_token.long()[live],
                       routes.slot.long()[live]), torch.ones(int(
                           live.sum())))
    gmat = gs * 0.0
    gmat = gmat.index_put((routes.route_token.long()[live],
                           routes.slot.long()[live]), g[live])
    ref_in = d.t() @ x
    ref_out = gmat @ y
    got_in = K9.moe_dispatch(x, routes)
    got_out = K9.moe_combine(y, g, routes)
    _close(got_in.detach().numpy(), ref_in.detach().numpy(), "dispatch")
    _close(got_out.detach().numpy(), ref_out.detach().numpy(), "combine")
    w_in, w_out = torch.from_numpy(_np(75, *got_in.shape)), \
        torch.from_numpy(_np(76, *got_out.shape))
    want = torch.autograd.grad((ref_in * w_in).sum() + (ref_out * w_out
                                                         ).sum(), (x, y, g))
    got = torch.autograd.grad((got_in * w_in).sum() + (got_out * w_out
                                                       ).sum(), (x, y, g))
    for n, a, b in zip("xyg", got, want):
        _close(a.numpy(), b.numpy(), n)


def test_k9_bf16_sum_rounds_each_add_in_route_order():
    # the expert-choice combine into bf16: acc = rnd(acc + rnd(g (y + b)))
    routes, *_ = _token_choice(16, 2, 16, seed=80)
    y = torch.from_numpy(_np(81, routes.slots, M)).bfloat16()
    b = torch.from_numpy(_np(82, E, M)).bfloat16()
    g = torch.from_numpy(np.abs(_np(83, routes.slot.numel())))
    spec = K9.CombineSpec(torch.bfloat16, torch.float32, torch.bfloat16,
                          torch.bfloat16)
    got = K9.moe_combine(y, g, routes, bias=b, spec=spec)
    want = torch.zeros(routes.tokens, M, dtype=torch.bfloat16)
    for t in range(routes.tokens):
        for r in range(int(routes.ptr[t]), int(routes.ptr[t + 1])):
            s = int(routes.slot[r])
            if s < 0:
                continue
            v = (y[s].float() + b[s // routes.capacity].float()).bfloat16()
            want[t] = (want[t].float() + (v.float() * g[r]).bfloat16()
                       .float()).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("act", ["relu", "gelu_tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_act_period_matches_a_per_expert_loop(dtype, act):
    # the bias add is bit-equal; torch's CPU GELU may differ by an ulp
    # between its vector and scalar loops, so GELU is held to 2 ulps of the
    # largest element
    y = torch.from_numpy(_np(90, E * 5, 24)).to(dtype).requires_grad_()
    b = torch.from_numpy(_np(91, E, 1, 24)).to(dtype).requires_grad_()
    spec = ba.ActSpec(act, dtype, dtype)
    out = ba.bias_act(y, b, spec, period=5)
    want = torch.cat([ba.bias_act_reference(y[e * 5:(e + 1) * 5],
                                            b[e].reshape(-1), spec)
                      for e in range(E)])
    dy = torch.from_numpy(_np(92, E * 5, 24)).to(dtype)
    gy, gb = torch.autograd.grad(out, (y, b), dy)
    wy, wb = torch.autograd.grad(want, (y, b), dy)
    ulp = torch.finfo(dtype).eps
    for a, w in ((out, want), (gy, wy)):
        if act == "relu":
            assert torch.equal(a, w)
        else:
            assert ((a - w).abs() <= 2 * ulp * w.abs().max()).all()
    np.testing.assert_allclose(gb.float().numpy(), wb.float().numpy(),
                               rtol=0, atol=1e-5 if dtype == torch.float32
                               else 2.0 ** -7 * float(wb.abs().max()))
    with pytest.raises(ValueError, match="multiple"):
        ba._bias_rows(b, 21, 24, 5)


def _fake_gather(y, routes, gate, bias, spec, fns=None):
    return K9.gather_sum_reference(y, routes, gate, bias, spec)


def _fake_rows(src, routes, gate, y, bias, out_dtype, h, fns=None):
    return K9.slot_rows_reference(src, routes, gate, y, bias, out_dtype, h)


def _fake_ba_fwd(y, b, spec, period=None, fns=None):
    with torch.no_grad():
        return ba.bias_act_reference(y, b, spec, period)


def _fake_ba_bwd(y, b, dy, spec, period=None, fns=None):
    dyy, db = ba.bias_act_bwd_reference(y, b, dy, spec, period)
    return dyy.to(y.dtype), None if db is None else db.to(b.dtype)


def _kernel_path(monkeypatch):
    """CPU tensors take the kernel path, each launch done by its plain
    version (and counted by the wrappers)."""
    for mod in (K9, ba):
        monkeypatch.setattr(mod, "plain_path", lambda t: False)
    monkeypatch.setattr(K9, "_launch_gather", _fake_gather)
    monkeypatch.setattr(K9, "_launch_rows", _fake_rows)

    def fwd(*a, **kw):
        ba.launches.count += 1
        return _fake_ba_fwd(*a, **kw)

    def bwd(*a, **kw):
        ba.launches.count += 1
        return _fake_ba_bwd(*a, **kw)
    monkeypatch.setattr(ba, "_launch_fwd", fwd)
    monkeypatch.setattr(ba, "_launch_bwd", bwd)


def _counts():
    return (K9.launches_dispatch.count, K9.launches_combine.count,
            ba.launches.count)


def _ec_grads():
    st = _ec_state(100, HID)
    ts = [torch.from_numpy(a).requires_grad_() for a in (
        _np(101, 2, 16, M), _np(102, 2, 16, E), st["w0"], st["b0"],
        st["w1"], st["b1"])]
    out = TF.fused_ec_moe(*ts)
    return [out] + list(torch.autograd.grad(out, ts, torch.from_numpy(
        _np(103, 2, 16, M))))


def _moe_grads(dense=False):
    _, tl, _ = _moe_pair(2, "gshard", 0.75)
    if dense:
        tl = tmoe.MoELayer(M, tl.experts, gate=_DenseGate(tl.gate))
    x = torch.from_numpy(_np(104, 2, 16, M)).requires_grad_()
    out = tl(x)
    loss = (out * torch.from_numpy(_np(105, 2, 16, M))).sum() + tl.l_aux
    return [out] + list(torch.autograd.grad(loss, [x] + list(
        tl.parameters())))


@pytest.mark.parametrize("path", ["ec_moe", "moe_layer", "moe_layer_dense"])
def test_autograd_functions_through_the_kernel_path(monkeypatch, path):
    run = {"ec_moe": _ec_grads, "moe_layer": _moe_grads,
           "moe_layer_dense": lambda: _moe_grads(dense=True)}[path]
    plain = run()
    _kernel_path(monkeypatch)
    before = _counts()
    kernel = run()
    counts = tuple(a - b for a, b in zip(_counts(), before))
    # dispatch and combine forward and backward; K6 (the expert-choice
    # bias and GELU) forward and backward, or the experts' GELUs
    assert counts == ((2, 2, 2) if path == "ec_moe" else (2, 2, 2 * E))
    for a, b in zip(plain, kernel):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_moe_step_under_capture_step_on_a_cpu_model(monkeypatch):
    # on the CPU a captured MoE step runs eagerly (bypass "cpu") and equals
    # the plain step, the optimizer in two parameter groups
    monkeypatch.setenv("PADDLE_TPU_STEP_CAPTURE", "auto")
    x = torch.from_numpy(_np(110, 2, 16, M))

    def build():
        _, tl, _ = _moe_pair(2, "gshard", 1.0)
        groups = [{"params": list(tl.gate.parameters()),
                   "learning_rate": 0.5},
                  {"params": list(tl.experts.parameters())}]
        return tl, AdamW(learning_rate=1e-2, parameters=groups,
                         use_multi_tensor=True)

    def loss_of(tl):
        return tl(x).square().mean() + 0.01 * tl.l_aux
    a, oa = build()
    b, ob = build()
    for _ in range(2):
        loss_of(a).backward()
        oa.step()
        oa.clear_grad()

    def step(x):
        loss = loss_of(b)
        loss.backward()
        return loss

    def update():
        ob.step()
        ob.clear_grad()
    cap = jit.capture_step(step, update_fn=update, nan_gate=True)
    for _ in range(2):
        cap(x)
    assert cap.stats["bypasses"] == {"cpu": 2}
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
