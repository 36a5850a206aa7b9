"""The port's utilities (`altro_tpu_torch/utils/{checkpoint,derivative_check,
benchmarking}.py`) against the JAX package's on the CPU: checkpoint round
trips of the port's state types, files crossing between the packages in
both directions, the finite differences on one callable, and the
benchmark harness (tests/test_infra.py:37-41)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu.solver.batched import BatchedTrajectory as JBatchedTrajectory
from altro_tpu.solver.functions import ConState as JConState
from altro_tpu.solver.mpc import MPCState as JMPCState
from altro_tpu.types import Trajectory as JTrajectory
from altro_tpu.utils import checkpoint as jcheckpoint
from altro_tpu.utils import derivative_check as jdc
from altro_tpu_torch import Trajectory
from altro_tpu_torch.models.unicycle import unicycle_rk4
from altro_tpu_torch.solver.batched import BatchedTrajectory
from altro_tpu_torch.solver.functions import ConState
from altro_tpu_torch.solver.mpc import MPCState
from altro_tpu_torch.utils import derivative_check as dc
from altro_tpu_torch.utils.benchmarking import benchmark
from altro_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from altro_tpu_torch.utils.tree import tree_flatten

N, n, m, B = 5, 3, 2, 4


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        X=rng.standard_normal((N + 1, n)), U=rng.standard_normal((N, m)), t=np.arange(N + 1) * 0.1,
        h=np.full(N, 0.1), Xb=rng.standard_normal((N + 1, n, B)), Ub=rng.standard_normal((N, m, B)),
        lam=rng.standard_normal((N, 4)), rho=rng.uniform(1, 10, N), lam_g=rng.standard_normal((1, n)),
        rho_g=np.ones(1), lam_b=rng.standard_normal((N, 4, B)), rho_b=rng.uniform(1, 10, (N, B)),
        status=np.int32(0), status_b=np.zeros(B, np.int32), it_b=np.arange(B, dtype=np.int32),
    )


def port_states(a, dtype=torch.float64):
    t = lambda k: torch.as_tensor(a[k]).to(dtype)  # noqa: E731
    Z = Trajectory(X=t("X"), U=t("U"), t=t("t"), h=t("h"))
    Zb = BatchedTrajectory(X=t("Xb"), U=t("Ub"), t=t("t"), h=t("h"))
    al = (ConState(lam=t("lam"), rho=t("rho")), ConState(lam=t("lam_g"), rho=t("rho_g")))
    al_b = (dict(lam=t("lam_b"), rho=t("rho_b")),)
    return dict(
        trajectory=Z, batched_trajectory=Zb, al=al, al_batched=al_b,
        mpc=MPCState(Z=Z, al=al, status=torch.as_tensor(a["status"]), iterations=7),
        mpc_batched=MPCState(Z=Zb, al=al_b, status=torch.as_tensor(a["status_b"]),
                             iterations=torch.as_tensor(a["it_b"])),
    )


def jax_states(a):
    t = lambda k: jnp.asarray(a[k])  # noqa: E731
    Z = JTrajectory(X=t("X"), U=t("U"), t=t("t"), h=t("h"))
    al = (JConState(lam=t("lam"), rho=t("rho")), JConState(lam=t("lam_g"), rho=t("rho_g")))
    return dict(
        trajectory=Z,
        batched_trajectory=JBatchedTrajectory(X=t("Xb"), U=t("Ub"), t=t("t"), h=t("h")),
        al=al, al_batched=(dict(lam=t("lam_b"), rho=t("rho_b")),),
        mpc=JMPCState(Z=Z, al=al, status=t("status"), iterations=jnp.asarray(7)),
    )


def _assert_same(got, want):
    g, gdef = tree_flatten(got)
    w, wdef = tree_flatten(want)
    assert gdef == wdef
    for x, y in zip(g, w):
        assert type(x) is type(y)
        if torch.is_tensor(y):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("kind", ["trajectory", "batched_trajectory", "al", "al_batched", "mpc", "mpc_batched"])
def test_checkpoint_round_trip(tmp_path, kind):
    """Every leaf back equal, with its dtype, device and kind; the host int
    `MPCState.iterations` comes back an int."""
    state = port_states(_arrays())[kind]
    save_pytree(tmp_path / "s.npz", state)
    _assert_same(load_pytree(tmp_path / "s.npz", state), state)


def test_checkpoint_dtype_comes_from_like(tmp_path):
    """A float64 save loads as float32 into a float32 `like`."""
    a = _arrays()
    save_pytree(tmp_path / "s.npz", port_states(a)["mpc"])
    like = port_states(a, torch.float32)["mpc"]
    got = load_pytree(tmp_path / "s.npz", like)
    _assert_same(got, like)


@pytest.mark.parametrize("kind", ["trajectory", "batched_trajectory", "al", "al_batched", "mpc"])
def test_checkpoint_crosses_between_packages(tmp_path, kind):
    """A file the JAX package saves loads into the port's `like` with equal
    leaves, and one the port saves into the JAX package's."""
    a = _arrays(1)
    port, jax_ = port_states(a)[kind], jax_states(a)[kind]
    jcheckpoint.save_pytree(tmp_path / "j.npz", jax_)
    _assert_same(load_pytree(tmp_path / "j.npz", port), port)
    save_pytree(tmp_path / "t.npz", port)
    back = jcheckpoint.load_pytree(tmp_path / "t.npz", jax_)
    import jax

    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_leaf_count_mismatch_raises(tmp_path):
    """A file with another number of leaves raises, with the JAX package's
    message, whichever package wrote it."""
    states = port_states(_arrays())
    save_pytree(tmp_path / "t.npz", states["trajectory"])
    with pytest.raises(ValueError, match="Checkpoint has 4 leaves; structure expects 10"):
        load_pytree(tmp_path / "t.npz", states["mpc"])
    jcheckpoint.save_pytree(tmp_path / "j.npz", jax_states(_arrays())["al"])
    with pytest.raises(ValueError, match="Checkpoint has 4 leaves; structure expects 2"):
        load_pytree(tmp_path / "j.npz", states["al_batched"])


def _f(x):
    """One callable for both packages: numpy arrays in the JAX package's
    checker, float64 tensors in the port's."""
    return [x[0] ** 2 * x[1], x[1] ** 3 - x[0] * x[2], x[2] ** 2 + 3.0 * x[0]]


def _scalar(x):
    return x[0] ** 2 * x[1] + x[1] ** 3 * x[2] - x[2] ** 4


def test_finite_differences_match_jax():
    """The four functions give the JAX package's numbers on one callable, to
    the callable's rounding (torch's and numpy's powers may differ by an
    ulp) over the step: 1e-16 / eps², eps = 1e-4 for the Hessian."""
    x, u = np.array([0.3, -1.2, 0.7]), np.array([1.5])
    g = lambda x_, u_: _f(x_ * u_[0])  # noqa: E731
    pairs = [
        (dc.finite_diff(_f, x), jdc.finite_diff(_f, x)),
        (dc.finite_diff(_f, x, central=False), jdc.finite_diff(_f, x, central=False)),
        (dc.finite_diff_gradient(_scalar, x), jdc.finite_diff_gradient(_scalar, x)),
        (dc.finite_diff_hessian(_scalar, x), jdc.finite_diff_hessian(_scalar, x)),
        *zip(dc.finite_diff_jacobian(g, x, u), jdc.finite_diff_jacobian(g, x, u)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_rk4_unicycle_jacobians_match_finite_differences():
    """The port's RK4 unicycle Jacobians (forward-mode AD) against
    `finite_diff_jacobian` within 1e-6."""
    model = unicycle_rk4()
    x, u = torch.tensor([0.2, -0.4, 0.9], dtype=torch.float64), torch.tensor([0.8, -0.3], dtype=torch.float64)
    t, h = torch.tensor(0.0, dtype=torch.float64), torch.tensor(0.1, dtype=torch.float64)
    A, Bm = model.jacobian(x, u, t, h)
    A_fd, B_fd = dc.finite_diff_jacobian(lambda x_, u_: model(x_, u_, t, h), x, u)
    np.testing.assert_allclose(A.numpy(), A_fd, atol=1e-6)
    np.testing.assert_allclose(Bm.numpy(), B_fd, atol=1e-6)


def test_benchmark_util():
    """tests/test_infra.py:37-41 on the port's harness."""
    res = benchmark(lambda: sum(range(1000)), samples=5, warmup=1, block=False)
    assert res.min <= res.median <= res.max
    assert len(res.samples_ms) == 5
    res = benchmark(lambda: torch.ones(8).sum(), samples=3)
    assert len(res.samples_ms) == 3 and "n=3" in repr(res)


def _jax_modules() -> list[str]:
    import pkgutil

    import altro_tpu

    return [""] + sorted(m.name[len("altro_tpu."):] for m in pkgutil.walk_packages(altro_tpu.__path__, "altro_tpu."))


# the port's module and name of each JAX kernel module and kernel function
PORT_MODULE = {"ops.backward_fused_pallas": "ops.backward_fused", "ops.forward_pallas": "ops.forward",
               "ops.riccati_pallas": "ops.riccati"}
PORT_NAME = {"riccati_pallas": "riccati_cuda"}
# the port's extra trailing keywords: where its tensors live and of what
# type, the kernels' device functor, compensated circle rows, the backward
# pass's count of host synchronisations, the forward kernel's timing mode
# (`chain_only`), (`Timer.trace_context`) the wait for the card that the
# JAX package's instrumented solve does apart, and the inner loop's lanes
# that the forward kernel's line search searches (`forward_pass`'s `active`)
EXTRA_KEYWORDS = {"dtype", "device", "cuda_model", "compensated_circles", "attempts", "chain_only", "block",
                  "active"}
# ROADMAP.md's "Not ported" entries, the only exceptions, each with its reason
NOT_PORTED_MODULES = {
    "_pytree": "JAX pytree registration: utils/tree.py walks the port's dataclasses in the same order, "
               "and each has its own `replace`",
    "solver.instrumented": "the host-stepped instrumented solve: the port's solve loops are on the host and "
                           "time their phases with Timer(active=...)",
}
NOT_PORTED = {
    ("solver.al", "ALSolver.timer"): "a property over the instrumented solve; the port's solver holds its Timer "
                                      "as an attribute",
    ("utils.timer", "Timer.activate"): "the instrumented solve's switch; Timer(active=...) takes its place",
    ("utils.timer", "Timer.deactivate"): "the instrumented solve's switch; Timer(active=...) takes its place",
    ("solver.batched", "bwhere"): "a jnp.where helper: torch.where broadcasts the same way",
    ("solver.batched", "btree_select"): "a jnp.where helper over pytrees: the port has al_select and zselect",
}
# ROADMAP.md's "Not ported" parameter: the TPU kernels' sublane pin,
# whose role FusedKernel.geometry plays on Hopper
NOT_PORTED_PARAMETERS = {
    ("options", "SolverOptions.__init__"): {"kernel_sublanes"},
}
# the TPU kernels' tile geometry (`sub`, `lane`) and Pallas's interpret
# mode, left out of the port (FusedKernel.geometry and the plain versions
# on CPU tensors take their place) only where no positional parameter
# follows them, so that a positional call binds the same arguments
TPU_PARAMETERS = {"sub", "lane", "interpret"}


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_a_counterpart(module):
    """Each public function and class of the JAX module, and each public
    method and property of such a class (with `__init__` and `__call__`),
    is found at the same path in the port, with the JAX parameters' names
    in their order, the JAX package's TPU parameters left out where they
    are keyword-only or last, followed by none but the port's extra
    keywords.  A JAX callable that takes `*args` or `**kwargs` has the
    port's parameters, kinds included; a JAX `__init__` that hands them to
    its base class's is held to the base's.  The only exceptions are
    ROADMAP.md's "Not ported" entries above, and each is held to still be
    missing."""
    import importlib
    import importlib.util
    import inspect

    jname = "altro_tpu" + (f".{module}" if module else "")
    tname = "altro_tpu_torch" + (f".{PORT_MODULE.get(module, module)}" if module else "")
    if module in NOT_PORTED_MODULES:
        assert importlib.util.find_spec(tname) is None
        return
    j, t = importlib.import_module(jname), importlib.import_module(tname)
    assert [n for n in getattr(j, "__all__", ()) if not hasattr(t, n)] == []

    def params(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()]

    def same_signature(jf, tf, owner=None, qual=None):
        sig = list(inspect.signature(jf).parameters.values())
        if any(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in sig):
            if jf.__name__ == "__init__" and "super().__init__(*args, **kwargs)" in inspect.getsource(jf):
                return same_signature(owner.__mro__[1].__init__, tf)
            kinds = [(p.name, p.kind) for p in inspect.signature(tf).parameters.values()]
            return kinds == [(p.name, p.kind) for p in sig]
        left_out = NOT_PORTED_PARAMETERS.get((module, qual), set())
        want = [
            p.name for i, p in enumerate(sig)
            if p.name not in left_out and not (p.name in TPU_PARAMETERS and all(
                q.kind == q.KEYWORD_ONLY or q.name in TPU_PARAMETERS for q in sig[i + 1:]))
        ]
        got = params(tf)
        return got[:len(want)] == want and set(got[len(want):]) <= EXTRA_KEYWORDS

    def unwrap(v):
        return v.__func__ if isinstance(v, (staticmethod, classmethod)) else v

    missing, differ = [], []
    for name, v in vars(j).items():
        if name.startswith("_") or not (inspect.isfunction(v) or inspect.isclass(v)) or v.__module__ != jname:
            continue
        tv = getattr(t, PORT_NAME.get(name, name), None)
        if tv is None:
            missing.append(name)
        elif inspect.isfunction(v):
            if not same_signature(v, tv, qual=name):
                differ.append(name)
        else:
            for mname, mv in vars(v).items():
                mv = unwrap(mv)
                if (mname.startswith("_") and mname not in ("__init__", "__call__")) or not (
                        inspect.isfunction(mv) or isinstance(mv, property)):
                    continue
                qual = f"{name}.{mname}"
                if not hasattr(tv, mname):
                    missing.append(qual)
                elif inspect.isfunction(mv) and not same_signature(
                        mv, unwrap(inspect.getattr_static(tv, mname)), v, qual):
                    differ.append(qual)
    excepted = sorted(q for (m, q) in NOT_PORTED if m == module)
    assert sorted(missing) == excepted
    assert differ == []
    for (m, qual), names in NOT_PORTED_PARAMETERS.items():
        if m == module:
            cls, meth = qual.split(".")
            assert names <= set(params(getattr(getattr(j, cls), meth)))
            assert not names & set(params(getattr(getattr(t, cls), meth)))


def test_compacted_solver_takes_every_jax_keyword():
    """`CompactedALSolver` takes the JAX class's keywords, in its order,
    with its defaults."""
    import inspect

    from altro_tpu.solver.compaction import CompactedALSolver as J
    from altro_tpu_torch.solver.compaction import CompactedALSolver as T

    pj, pt = inspect.signature(J.__init__).parameters, inspect.signature(T.__init__).parameters
    assert list(pj) == list(pt)
    assert all(pj[k].default == pt[k].default for k in pj)
