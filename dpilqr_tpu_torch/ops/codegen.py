"""Device right-hand sides of custom (sympy) models, generated as CUDA C++.

The kernels that integrate a fleet (K2 ``csrc/forward_batched.cu``, K4
``csrc/forward_sweep.cu``) and the one that differentiates it (K5
``csrc/backward_sweep.cu``, on dual numbers) switch on a model id in
``rhs`` of ``csrc/dynamics.cuh``.  The nine built-in models are compiled in;
a custom model that carries its sympy form (``ModelSpec.expr``, set by
``api.SymbolicModel``) reaches the same switch through a header this module
prints from that form, which ``ops.cuda_build`` compiles into a second
library (``-DDPILQR_CUSTOM_MODELS``).

The header holds one ``template <int NXC, typename T>`` function a distinct
vector field, instantiated on ``float``, ``double`` and ``Dual<float>``,
``Dual<double>`` (``csrc/derivatives.cuh``), and the dispatcher
``custom_rhs``.  Fields are told apart by content: each is renamed to the
symbols ``x0..``, ``u0..`` and keyed by its ``srepr``, so 100 instances of
one field (``api.SymbolicModel`` hands each a fresh ``model_id``) give one
function, one header and one build.  Its case in the dispatcher is a
library-local id, ``CUSTOM_BASE + k`` for the k-th distinct field of the
fleet; ``library_ids`` maps a fleet's models onto them.

Printing (a subclass of sympy's C99 printer, after ``sympy.cse``): every
number as ``T(...)``, so a float32 instance stays in float32; integer powers
as products; ``sin``, ``cos``, ``tan``, ``exp``, ``log``, ``sqrt``,
``Abs``, ``atan2``, ``tanh`` and other powers as the ``d_*`` functions of
``dynamics.cuh`` (and their dual overloads).  Any other construct raises
``NotImplementedError`` naming it, at generation time: nothing falls back.

sympy is imported only inside these functions, and only for specs that
carry a sympy form (which sympy built).
"""

from __future__ import annotations

from functools import lru_cache

from ..models.specs import ModelSpec, SymbolicRHS

# Library-local id of a fleet's first distinct custom field.
CUSTOM_BASE = 1000
# Widest state and control the kernels compile (MAX_NX, MAX_NU in
# csrc/dynamics.cuh).
MAX_NX = 12
MAX_NU = 4

# sympy function -> device function (dynamics.cuh; dual overloads in
# derivatives.cuh).  Powers print apart: integer exponents as products,
# 1/2 as d_sqrt, any other as d_pow.
FUNCTIONS = {
    "sin": "d_sin",
    "cos": "d_cos",
    "tan": "d_tan",
    "exp": "d_exp",
    "log": "d_log",
    "Abs": "d_abs",
    "atan2": "d_atan2",
    "tanh": "d_tanh",
}


def _printer_class():
    """The C++ printer, made on first use (sympy loads here)."""
    from sympy import Integer
    from sympy.printing.c import C99CodePrinter

    class DevicePrinter(C99CodePrinter):
        """sympy's C99 printer with every number a ``T(...)`` and every
        function one of the ``d_*`` of dynamics.cuh."""

        def _print_Integer(self, expr):
            return f"T({int(expr)})"

        _print_Zero = _print_One = _print_NegativeOne = _print_Integer

        def _print_Rational(self, expr):
            return f"T({int(expr.p)}.0 / {int(expr.q)}.0)"

        _print_Half = _print_Rational

        def _print_Float(self, expr):
            return f"T({float(expr)!r})"

        def _print_NumberSymbol(self, expr):
            return f"T({float(expr)!r})"

        _print_Pi = _print_Exp1 = _print_GoldenRatio = _print_NumberSymbol
        _print_EulerGamma = _print_Catalan = _print_TribonacciConstant = (
            _print_NumberSymbol)

        def _print_Pow(self, expr):
            base, e = expr.base, expr.exp
            if e.is_Integer and e != 0 and abs(int(e)) <= 16:
                prod = "*".join([self.parenthesize(base, 100)] * abs(int(e)))
                return f"({prod})" if e > 0 else f"(T(1)/({prod}))"
            if e == Integer(1) / 2:
                return f"d_sqrt({self._print(base)})"
            if e == -Integer(1) / 2:
                return f"(T(1)/d_sqrt({self._print(base)}))"
            return f"d_pow({self._print(base)}, {self._print(e)})"

        def _print_device_function(self, expr):
            args = ", ".join(self._print(a) for a in expr.args)
            return f"{FUNCTIONS[type(expr).__name__]}({args})"

    for name in FUNCTIONS:
        setattr(DevicePrinter, f"_print_{name}", DevicePrinter._print_device_function)
    return DevicePrinter


@lru_cache(maxsize=None)
def _printer():
    return _printer_class()()


def _unsupported(expr, allowed) -> str | None:
    """The first construct of ``expr`` the printer does not take (by name),
    or a free symbol outside ``allowed``; None when there is none."""
    import sympy

    for node in sympy.preorder_traversal(expr):
        if node.is_Symbol:
            if node not in allowed:
                return f"the free symbol {node} (neither a state nor a control)"
        elif node.is_Add or node.is_Mul or node.is_Pow:
            continue
        elif node.is_Number:
            if not (node.is_real and node.is_finite):
                return f"the number {node}"
        elif isinstance(node, sympy.NumberSymbol):
            continue
        elif isinstance(node, sympy.Function) and type(node).__name__ in FUNCTIONS:
            continue
        else:
            return f"the function {type(node).__name__}"
    return None


class Field:
    """One vector field renamed to the symbols ``x0..``, ``u0..``: its
    expressions and its content key (``srepr``)."""

    def __init__(self, rhs: SymbolicRHS, n_x: int, n_u: int):
        import sympy

        states, controls, field = tuple(rhs.states), tuple(rhs.controls), tuple(rhs.field)
        if (len(states), len(controls), len(field)) != (n_x, n_u, n_x):
            raise ValueError(
                f"a symbolic right-hand side of {len(field)} components over "
                f"{len(states)} states and {len(controls)} controls does not "
                f"match n_x={n_x}, n_u={n_u}")
        self.n_x, self.n_u = n_x, n_u
        self.x = sympy.symbols(f"x0:{n_x}")
        self.u = sympy.symbols(f"u0:{n_u}")
        rename = dict(zip(states + controls, self.x + self.u))
        self.exprs = tuple(sympy.sympify(e).xreplace(rename) for e in field)
        self.key = sympy.srepr((n_x, n_u, self.exprs))
        bad = (_unsupported(e, set(self.x + self.u)) for e in self.exprs)
        self.unsupported = next((b for b in bad if b), None)

    def code(self, model: int) -> str:
        """The field's device function ``custom_rhs_<model>``."""
        import sympy

        if self.unsupported:
            raise NotImplementedError(
                f"the CUDA code generator does not support {self.unsupported}")
        p = _printer()
        subs, outs = sympy.cse(list(self.exprs), symbols=sympy.numbered_symbols("c"))
        used = set().union(*(e.free_symbols for e in self.exprs))
        lines = [f"// Field {model}: n_x {self.n_x}, n_u {self.n_u}.",
                 "template <int NXC, typename T>",
                 f"DPILQR_HD __forceinline__ void custom_rhs_{model}("
                 "const T (&x)[NXC], const T* u, T (&xd)[NXC]) {",
                 f"  if constexpr (NXC >= {self.n_x}) {{"]
        lines += [f"    const T {s} = x[{i}];" for i, s in enumerate(self.x) if s in used]
        lines += [f"    const T {s} = u[{i}];" for i, s in enumerate(self.u) if s in used]
        lines += [f"    const T {s} = {p.doprint(e)};" for s, e in subs]
        lines += [f"    xd[{i}] = {p.doprint(e)};" for i, e in enumerate(outs)]
        lines += ["  }", "}"]
        return "\n".join(lines)


@lru_cache(maxsize=None)
def field_of(rhs: SymbolicRHS, n_x: int, n_u: int) -> Field:
    """The renamed field of a spec's sympy form (cached by the form's
    identity)."""
    return Field(rhs, n_x, n_u)


def not_kernel_ready(spec: ModelSpec) -> str | None:
    """Why ``spec`` cannot run in the CUDA kernels, or None when it can: a
    built-in, or a custom spec with a sympy form no wider than the kernels'
    ``MAX_NX`` / ``MAX_NU`` that uses only what the printer supports."""
    if spec.builtin:
        return None
    if spec.expr is None:
        return ("it has no symbolic form (a ModelSpec given only f; "
                "api.SymbolicModel gives one)")
    if spec.n_x > MAX_NX or spec.n_u > MAX_NU:
        return (f"it is too wide (n_x {spec.n_x}, n_u {spec.n_u}; the kernels "
                f"take n_x <= {MAX_NX}, n_u <= {MAX_NU})")
    f = field_of(spec.expr, spec.n_x, spec.n_u)
    if f.unsupported:
        return f"the CUDA code generator does not support {f.unsupported}"
    return None


def _fields(specs) -> dict[str, Field]:
    """The distinct fields of the custom specs among ``specs``, by key, in
    first-appearance order."""
    out: dict[str, Field] = {}
    for s in specs:
        if not s.builtin and s.expr is not None:
            f = field_of(s.expr, s.n_x, s.n_u)
            out.setdefault(f.key, f)
    return out


# The caches below key on the specs AND the identity of their sympy forms:
# specs compare equal without their forms, so equal specs may carry two.
@lru_cache(maxsize=256)
def _library_ids(specs, _forms) -> tuple[int, ...]:
    keys = list(_fields(specs))
    return tuple(
        s.model_id if s.builtin or s.expr is None
        else CUSTOM_BASE + keys.index(field_of(s.expr, s.n_x, s.n_u).key)
        for s in specs)


def library_ids(specs) -> tuple[int, ...]:
    """The id each of ``specs`` has in the library that runs them: a
    built-in's ``model_id``, a custom field's ``CUSTOM_BASE + k`` (k its
    place among the distinct fields of ``specs``).  A custom spec without a
    sympy form keeps its ``model_id``: no kernel takes it
    (``cuda_build.require_kernel_models`` refuses it first)."""
    specs = tuple(specs)
    return _library_ids(specs, tuple(s.expr for s in specs))


@lru_cache(maxsize=64)
def _header(specs, _forms) -> str:
    fields = list(_fields(specs).values())
    ids = [CUSTOM_BASE + k for k in range(len(fields))]
    parts = [
        "// Generated by dpilqr_tpu_torch/ops/codegen.py from "
        f"{len(fields)} sympy vector field(s); do not edit.",
        "// Included by csrc/dynamics.cuh inside its anonymous namespace when",
        "// built with -DDPILQR_CUSTOM_MODELS.",
        "#pragma once",
        "",
    ]
    parts += [f.code(m) + "\n" for f, m in zip(fields, ids)]
    parts += [
        "// The custom models' right-hand sides by library-local id; xd is",
        "// zero on entry (rhs in dynamics.cuh).",
        "template <int NXC, typename T>",
        "DPILQR_HD __forceinline__ void custom_rhs(int model, const T (&x)[NXC], "
        "const T* u, T (&xd)[NXC]) {",
        "  switch (model) {",
        *(f"    case {m}: custom_rhs_{m}(x, u, xd); break;" for m in ids),
        "    default: break;",
        "  }",
        "}",
        "",
    ]
    return "\n".join(parts)


def generate_header(specs) -> str:
    """The header of the distinct custom fields among ``specs`` (one
    function each and the dispatcher ``custom_rhs``); raises
    ``NotImplementedError`` naming a construct the printer does not take."""
    specs = tuple(specs)
    return _header(specs, tuple(s.expr for s in specs))
