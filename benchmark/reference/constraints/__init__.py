"""The constraints the plain reference knows, one file a kind:
`<kind>.py`, found by the name in a configuration's `problem.constraints`.
Adding a kind adds its file.  A kind's module holds

- `KNOTS`: "stage" (rows at knots 0..N-1, on x_k and u_k) or "terminal"
  (rows at knot N, on x_N alone);
- `EQUALITY`: whether its rows hold at 0 (else at ≤ 0);
- `build(entry, n, m, xf, vec) -> data`: its data as tensors, from the
  configuration's entry (`vec(value, size)` makes a vector of a scalar or
  a list);
- `rows(data, n, m)`: its rows a knot;
- `value(data, x, u) -> c [..., rows]` (u is None at the terminal knot);
- `al_terms(data, x, u, lam, rho) -> (J, terms)`: the augmented
  Lagrangian's cost of its rows and their gradient and Gauss-Newton
  Hessian, keyed by the expansion term they add to (`lx`, `lu`, `lxx`,
  `luu`; at the terminal knot `lx`, `lxx` add to x_N's).
"""
from __future__ import annotations

import importlib


def kind(name: str):
    """The module of the constraint kind `name`, `constraints/<name>.py`."""
    return importlib.import_module(f"{__name__}.{name}")
