"""The 11 custom macro extensions (paper §II-C) as a structural inventory;
the port's own copy of ``repro.core.macros``.

Each macro is described by its role in the column netlist (multiplicity as a
function of column shape p x q) and its transistor counts in the two
libraries:

    * ``standard`` — composed from stock ASAP7 standard cells,
    * ``custom``   — the paper's GDI-based hard macros.

Transistor counts anchor the complexity model. Two are given explicitly by
the paper (mux2to1gdi: 2T custom vs 12T standard; less_equal: pass-transistor
custom vs a "significantly more complex" std-cell module); the rest are
engineering estimates consistent with the paper's aggregate claim for the
prototype (~32M gates / ~128M transistors, Fig. 19) — the PPA numbers
themselves are NOT derived from these counts but calibrated directly against
Tables I/II (see hwmodel.py); the counts feed the complexity report only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Macro:
    name: str
    description: str
    t_std: int  # transistors, ASAP7 standard-cell composition
    t_custom: int  # transistors, custom GDI macro
    # multiplicity in a p x q column: fn(p, q) -> count
    count: Callable[[int, int], int]


def _per_synapse(p: int, q: int) -> int:
    return p * q


def _per_neuron(p: int, q: int) -> int:
    return q


def _per_column(p: int, q: int) -> int:
    return 1


def _per_input(p: int, q: int) -> int:
    return p


def _adder_units(p: int, q: int) -> int:
    # parallel accumulative counter: ~(p-1) single-bit adder stages per neuron
    return q * max(p - 1, 1)


MACROS: Tuple[Macro, ...] = (
    Macro("syn_weight_update", "3-bit saturating up/down weight counter FSM (Fig. 2)",
          136, 100, _per_synapse),
    Macro("syn_output", "8-cycle input pulse -> thermometer-coded RNL response (Fig. 3)",
          80, 60, _per_synapse),
    Macro("pac_adder", "single-bit adder unit of the parallel accumulative counter (Fig. 4)",
          36, 28, _adder_units),
    Macro("less_equal", "pass-transistor time comparator for WTA inhibition (Fig. 5)",
          44, 10, _per_neuron),
    Macro("pulse2edge", "spike pulse -> level until gamma reset (Figs. 6-7)",
          30, 18, _per_neuron),
    Macro("stdp_case_gen", "input/output timing relationship -> 4 STDP cases (Fig. 8)",
          52, 30, _per_synapse),
    Macro("stabilize_func", "weight-indexed 8-to-1 BRV mux (7x mux2to1gdi) (Fig. 9)",
          84, 22, _per_synapse),
    Macro("incdec", "case x BRV -> increment/decrement controls (Fig. 10)",
          28, 16, _per_synapse),
    Macro("mux2to1gdi", "2-transistor GDI 2:1 mux + level restorer (Figs. 11/16/17)",
          12, 2, lambda p, q: 0),  # counted inside stabilize_func
    Macro("edge2pulse", "gclk edge -> gamma reset pulse grst (Fig. 13)",
          26, 14, _per_column),
    Macro("spike_gen", "8-cycle-wide spike pulse generator per input line (Fig. 12)",
          40, 24, _per_input),
)

MACRO_BY_NAME: Dict[str, Macro] = {m.name: m for m in MACROS}


def column_transistors(p: int, q: int, library: str) -> int:
    """Total transistor count of a p x q column in the given library."""
    if library not in ("standard", "custom"):
        raise ValueError(f"unknown library {library!r}")
    total = 0
    for m in MACROS:
        t = m.t_std if library == "standard" else m.t_custom
        total += t * m.count(p, q)
    return total


def column_gates(p: int, q: int, library: str) -> float:
    """Gate-equivalents (4 transistors per NAND2-equivalent gate)."""
    return column_transistors(p, q, library) / 4.0
