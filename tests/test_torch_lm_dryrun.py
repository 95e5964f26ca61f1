"""The LM half of the port's dry run (``repro_torch.launch.dryrun``), its
specs (``launch.specs``) and the roofline report and compare
(``roofline.report``, ``roofline.compare``) against the JAX package's.

- ``input_specs`` of every arch x shape-grid cell: the reference's trees,
  shapes and dtypes (``meta`` tensors in the port, ``ShapeDtypeStruct``
  there).
- One analytic row per cell kind on the 16x16 shape (and the train row on
  2x16x16): ``arg_bytes_per_chip`` equals the reference's formula (each
  leaf's block under its ``NamedSharding``, ceil-divided, times its element
  size) with the reference's own specs and rules on the same mesh stub, and
  ``analytic_activation_bytes`` is the reference's function's value; the
  rows carry the reference's keys and ``"analytic": true``.
- The report's tables on a directory of the port's rows are the reference's
  report's on the same rows, row for row, once the reference's "16G" fit
  column reads the port's 80 GB flag; compare prints what the reference's
  compare prints.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.configs.base import SHAPE_GRID as J_GRID
from repro.launch import dryrun as j_dryrun
from repro.launch import specs as j_specs
from repro.models import model as JM
from repro.roofline import compare as j_compare
from repro.roofline import report as j_report
from repro.sharding import partition as JPT
from repro.train import optimizer as JO
from repro.train import train_step as JTS

from repro_torch.configs import ARCHS, SHAPE_GRID
from repro_torch.configs import get_config as t_get
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import specs as t_specs
from repro_torch.models.params import tree_flatten
from repro_torch.roofline import compare as t_compare
from repro_torch.roofline import report as t_report
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TORCH_DT = {torch.float32: np.float32, torch.bfloat16: jax.numpy.bfloat16,
            torch.int32: np.int32}


class Stub:
    def __init__(self, shape):
        self.shape = shape


def _jleaves(tree):
    return [("".join(f"[{k.key!r}]" if hasattr(k, "key") else f"[{k.idx}]" for k in p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tleaves(tree):
    return [("".join(f"[{k!r}]" for k in p), v)
            for p, v in tree_flatten(tree, lambda x: isinstance(x, torch.Tensor))]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references(arch):
    jc, tc = j_get(arch), t_get(arch)
    for jcell, tcell in zip(J_GRID, SHAPE_GRID):
        assert dataclasses.asdict(jcell) == dataclasses.asdict(tcell)
        want, got = _jleaves(j_specs.input_specs(jc, jcell)), _tleaves(
            t_specs.input_specs(tc, tcell))
        assert [p for p, _ in want] == [p for p, _ in got], (arch, jcell.name)
        for (p, a), (_, b) in zip(want, got):
            assert tuple(a.shape) == tuple(b.shape) and b.device.type == "meta", p
            assert np.dtype(a.dtype) == np.dtype(TORCH_DT[b.dtype]), p


def _block_bytes(leaves, specs, mesh):
    """The reference's ``arg_bytes_per_chip``: each block's elements (its
    dims ceil-divided by their axes' sizes) times the element size."""
    total = 0
    for a, spec in zip(leaves, specs):
        n = 1
        for d, part in zip(a.shape, tuple(spec) + (None,) * (len(a.shape) - len(spec))):
            group = () if part is None else ((part,) if isinstance(part, str) else part)
            k = int(np.prod([mesh.shape.get(x, 1) for x in group])) if group else 1
            n *= -(-d // k)
        total += n * np.dtype(a.dtype).itemsize
    return float(total)


def _reference_args_bytes(arch, cell, mesh, prof):
    """The reference's args and specs as its ``build_lowerable`` assigns
    them, on a mesh stub (its ``spec_for`` and rules; batch rows over the
    data axes where they divide, ``pos`` replicated)."""
    cfg = j_dryrun._tuned(j_get(arch), mesh, None, prof)
    p_rules, a_rules = JPT.param_rules(mesh, prof), JPT.act_rules(mesh, prof)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp = int(np.prod([mesh.shape[a] for a in dp_axes]))

    def specs_of(tree, axes, rules):
        leaves = jax.tree.leaves(tree)
        ax = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple) and all(
            a is None or isinstance(a, str) for a in x))
        assert len(ax) == len(leaves)
        return leaves, [JPT.spec_for(a.shape, x, mesh, rules) for a, x in zip(leaves, ax)]

    def batch(tree):
        leaves = jax.tree.leaves(tree)
        return leaves, [((dp_axes if a.ndim and a.shape[0] % dp == 0 else None),)
                        if a.ndim else () for a in leaves]

    leaves, specs = [], []
    if cell.kind == "train":
        jo = JO.OptConfig(name=JO.default_opt_for(cfg.n_params()))
        l, s = specs_of(JTS.abstract_state(cfg, jo), JTS.state_axes(cfg, jo), p_rules)
        leaves += l
        specs += s
        l, s = batch(j_specs.train_batch_specs(cfg, cell))
        return cfg, leaves + l, specs + s
    l, s = specs_of(JM.abstract_params(cfg), JM.param_axes(cfg), p_rules)
    leaves += l
    specs += s
    sp = j_specs.input_specs(cfg, cell)
    cl, cs = specs_of(sp["cache"], JM.cache_axes(cfg, sp["cache"]), a_rules)
    for k in ("tokens", "token", "embeds", "frames"):
        if k in sp:
            l, s = batch(sp[k])
            leaves += l
            specs += s
    if "pos" in sp:
        leaves.append(sp["pos"])
        specs.append(())
    return cfg, leaves + cl, specs + cs


@pytest.mark.parametrize("arch,cell,multi", [
    ("llama3.2-3b", "train_4k", False), ("mixtral-8x22b", "train_4k", True),
    ("llama3.2-3b", "prefill_32k", False), ("internvl2-76b", "prefill_32k", False),
    ("zamba2-7b", "decode_32k", False), ("grok-1-314b", "decode_32k", False),
    ("xlstm-125m", "long_500k", False)])
def test_lm_row_equals_the_reference_formulas(arch, cell, multi):
    tcell = next(c for c in SHAPE_GRID if c.name == cell)
    jcell = next(c for c in J_GRID if c.name == cell)
    row = t_dryrun.run_lm_cell(arch, tcell, multi, verbose=False)
    assert row["status"] == "ok" and row["analytic"] is True, row.get("traceback")
    mesh = Stub(t_dryrun.PRODUCTION_MESHES["2x16x16" if multi else "16x16"])
    prof = JPT.RunProfile(**row["profile"])
    cfg, leaves, specs = _reference_args_bytes(arch, jcell, mesh, prof)
    mem = row["memory"]
    assert mem["analytic_args_bytes"] == _block_bytes(leaves, specs, mesh)
    assert mem["analytic_activation_bytes"] == j_dryrun.analytic_activation_bytes(
        cfg, jcell, mesh)
    assert mem["fits_80g_hbm"] == (mem["analytic_total_bytes"] < 80e9)
    assert row["n_params"] == cfg.n_params() and row["n_active_params"] == cfg.n_active_params()
    if tcell.kind == "prefill":
        assert row["roofline"] is None and "prefill" in row["roofline_reason"]
    else:
        rf = row["roofline"]
        assert rf["profile"] == "h100-sxm-bf16"
        for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                  "roofline_fraction", "useful_flop_fraction"):
            assert k in rf
        assert rf["model_flops_per_chip"] == row["model_flops_per_chip"]


def _rows_dir(tmp_path):
    d = tmp_path / "rows"
    archs = ["llama3.2-3b", "xlstm-125m", "whisper-tiny"]
    assert t_dryrun.run_lm(archs, list(SHAPE_GRID), [False, True], str(d)) == 0
    return d


def test_report_and_compare_print_the_references_tables(tmp_path, capsys):
    d = _rows_dir(tmp_path)
    capsys.readouterr()
    rows = t_report.load_all(str(d))
    # the reference's report reads its "16G" flag: give it the port's 80 GB one
    jrows = [dict(r, memory=dict(r["memory"], fits_16g_hbm=r["memory"]["fits_80g_hbm"]))
             if "memory" in r else r for r in rows]

    def table(text):
        return [l for l in text.splitlines() if l.startswith("|") or l.startswith("**")]

    want = table(j_report.dryrun_section(jrows))
    got = table(t_report.dryrun_section(rows))
    assert want[0].replace("fits 16G", "fits 80G") == got[0]
    assert want[1:] == got[1:] and len(got) == len(rows) + 3
    counted = [r for r in jrows if r.get("roofline")]
    assert table(j_report.roofline_section(counted)) == table(t_report.roofline_section(rows))
    # compare: the reference reads only rows with a roofline; so does the port
    only = tmp_path / "counted"
    only.mkdir()
    for r in rows:
        if r.get("roofline"):
            name = f"{r['arch'].replace('.', '_')}__{r['cell']}__{r['mesh']}.json"
            (only / name).write_text(json.dumps(r))
    import sys
    argv = sys.argv
    try:
        sys.argv = ["compare", str(only), str(only)]
        j_compare.main()
        want = capsys.readouterr().out
    finally:
        sys.argv = argv
    t_compare.main([str(only), str(only)])
    assert capsys.readouterr().out == want
    t_compare.main([str(d), str(d)])          # rows without counts are left out
    assert "0 cells improved" in capsys.readouterr().out
