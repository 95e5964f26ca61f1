"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's (``repro.sharding``), pure Python on mesh-shape stubs (as
``tests/test_sharding_roofline.py`` stubs them): ``param_rules`` and
``act_rules`` for every profile, ``spec_for`` and ``report_fallbacks`` on
every registry arch's params and on its AdamW and Adafactor train state
(with and without gradient compression), element for element; the
``abstract_params``, ``param_axes`` and ``cache_axes`` trees in shapes,
dtypes and axes; ``shard_activation`` a no-op outside a context.

This jax version's ``PartitionSpec`` reads a one-axis tuple ``("data",)``
back as ``"data"``; the port keeps the rules' own form, so entries are
compared with one-axis tuples read as their axis.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get
from repro.models import model as JM
from repro.sharding import partition as JPT
from repro.train import optimizer as JO
from repro.train import train_step as JTS

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import model as TM
from repro_torch.models.params import tree_flatten
from repro_torch.sharding import context as C
from repro_torch.sharding import partition as PT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "4x1": {"data": 4, "model": 1}}
PROFILES = [dict(), dict(fsdp=False), dict(long_context=True), dict(seq_parallel=True)]
TORCH_DT = {torch.float32: np.float32, torch.bfloat16: jnp.bfloat16, torch.int32: np.int32}


class Stub:
    def __init__(self, shape):
        self.shape = shape


def _norm(spec):
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def _jflat(tree, is_leaf=None):
    return [("".join(f"[{k.key!r}]" if hasattr(k, "key") else f"[{k.idx}]" for k in p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _tflat(tree, is_leaf=lambda x: False):
    return [(PT.keystr(p), v) for p, v in tree_flatten(tree, is_leaf)]


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def test_registry_is_the_references():
    assert list(ARCHS) == list(J_ARCHS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_equal_the_references(mesh):
    shape = MESHES[mesh]
    for kw in PROFILES:
        jp, tp = JPT.RunProfile(**kw), PT.RunProfile(**kw)
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        assert PT.param_rules(shape, tp) == JPT.param_rules(Stub(shape), jp)
        assert PT.act_rules(shape, tp) == JPT.act_rules(Stub(shape), jp)


def test_spec_for_divisibility_and_conflicts():
    """The reference's own cases (``tests/test_sharding_roofline.py``)."""
    rules = {"embed": ("data",), "mlp": "model", "heads": "model"}
    m = MESHES["16x16"]
    for shape, axes in (((3072, 8192), ("embed", "mlp")), ((3072, 24, 128), ("embed", "heads", None)),
                        ((64, 128), ("mlp", "heads")), ((73448,), ("mlp",))):
        want = JPT.spec_for(shape, axes, Stub(m), rules)
        got = PT.spec_for(shape, axes, m, rules)
        assert _norm(got) == tuple(want)
    assert PT.spec_for((3072, 8192), ("embed", "mlp"), m, rules) == (("data",), "model")


def _state_cases():
    return [("adamw", False), ("adamw", True), ("adafactor", False), ("adafactor", True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_equal_the_references(arch):
    jc, tc = j_get(arch), get_config(arch)
    # the trees: shapes, dtypes, axes
    ja, ta = _jflat(JM.abstract_params(jc)), _tflat(TM.abstract_params(tc),
                                                   lambda x: isinstance(x, torch.Tensor))
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (p, a), (_, b) in zip(ja, ta):
        assert tuple(a.shape) == tuple(b.shape) and b.device.type == "meta", p
        assert np.dtype(a.dtype) == np.dtype(TORCH_DT[b.dtype]), p
    jx, tx = _jflat(JM.param_axes(jc), _is_axes), _tflat(TM.param_axes(tc), _is_axes)
    assert jx == tx
    for name, compress in _state_cases():
        jo = JO.OptConfig(name=name, compress_grads=compress)
        to = TO.OptConfig(name=name, compress_grads=compress)
        jsx = _jflat(JTS.state_axes(jc, jo), _is_axes)
        tsx = _tflat(TTS.state_axes(tc, to), _is_axes)
        assert jsx == tsx, (name, compress)
        jabs = _jflat(JTS.abstract_state(jc, jo))
        tabs = _tflat(TTS.abstract_state(tc, to), lambda x: isinstance(x, torch.Tensor))
        assert [(p, tuple(a.shape)) for p, a in jabs] == [(p, tuple(b.shape)) for p, b in tabs]
    for mesh, shape in MESHES.items():
        for kw in (dict(), dict(long_context=True), dict(seq_parallel=True)):
            jr = JPT.param_rules(Stub(shape), JPT.RunProfile(**kw))
            tr = PT.param_rules(shape, PT.RunProfile(**kw))
            for (p, a), (_, ax) in zip(ta, tx):
                want = JPT.spec_for(tuple(a.shape), ax, Stub(shape), jr)
                assert _norm(PT.spec_for(tuple(a.shape), ax, shape, tr)) == tuple(want), (mesh, p)
            jfb = JPT.report_fallbacks(JM.abstract_params(jc), JM.param_axes(jc), Stub(shape), jr)
            tfb = PT.report_fallbacks(TM.abstract_params(tc), TM.param_axes(tc), shape, tr)
            assert sorted(jfb) == sorted(tfb), mesh
            for k, (s, ax, got) in tfb.items():
                assert (tuple(jfb[k][0]), tuple(jfb[k][1]), tuple(jfb[k][2])) == (
                    s, ax, _norm(got)), (mesh, k)
        # the train state's specs (AdamW and Adafactor, compressed)
        for name in ("adamw", "adafactor"):
            jo, to = JO.OptConfig(name=name, compress_grads=True), TO.OptConfig(
                name=name, compress_grads=True)
            jr = JPT.param_rules(Stub(shape), JPT.RunProfile())
            tsh = PT.shardings_for_tree(TTS.abstract_state(tc, to), TTS.state_axes(tc, to),
                                        shape, PT.param_rules(shape, PT.RunProfile()))
            jl = _jflat(JTS.abstract_state(jc, jo))
            jax_ = dict(_jflat(JTS.state_axes(jc, jo), _is_axes))
            tl = dict(_tflat(tsh, lambda x: isinstance(x, PT.NamedSharding)))
            for p, a in jl:
                want = JPT.spec_for(tuple(a.shape), jax_[p], Stub(shape), jr)
                assert _norm(tl[p].spec) == tuple(want), (mesh, name, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_trees_equal_the_references(arch):
    jc, tc = j_get(arch), get_config(arch)
    B, S = 8, 64
    jcache = jax.eval_shape(lambda: JM.init_cache(jc, B, S, jnp.bfloat16))
    tcache = TM.init_cache(tc, B, S, torch.bfloat16, device="meta")
    ja, ta = _jflat(jcache), _tflat(tcache, lambda x: isinstance(x, torch.Tensor))
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (p, a), (_, b) in zip(ja, ta):
        assert tuple(a.shape) == tuple(b.shape), p
        assert np.dtype(a.dtype) == np.dtype(TORCH_DT[b.dtype]), p
    assert _jflat(JM.cache_axes(jc, jcache), _is_axes) == _tflat(TM.cache_axes(tc, tcache),
                                                                 _is_axes)


def test_shard_activation_is_a_no_op_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert not C.active()
    assert C.shard_activation(x, ("batch", "seq", "embed")) is x
    assert C.replicate(x) is x
    with C.use_partitioning(MESHES["2x2"], PT.act_rules(MESHES["2x2"], PT.RunProfile())):
        assert C.active()
        # a plain tensor inside a context (a one-process call) is left alone
        assert C.shard_activation(x, ("batch", "seq", "embed")) is x
        assert C.logical_to_spec(("batch", "seq", "mlp")) == (("data",), None, "model")
    assert not C.active()
