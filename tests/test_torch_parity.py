"""Every public name of qb3_tpu has its counterpart in qb3_tpu_torch.

For each module of qb3_tpu/, the module of the same path in
qb3_tpu_torch/ holds a same-named function or class for each public
top-level one, a same-named method for each public method (and __init__)
of such a class, each of their parameter names, and the same default where
both give one.  The port's extra keywords (device=, devices=) are
additions and pass.  Both packages are read with ast and imported by
neither test, so no JAX loads and no jit wrapper hides a signature.
EXCEPTIONS holds each difference that is by design, with its reason.
"""

import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "qb3_tpu"), os.path.join(ROOT, "qb3_tpu_torch")

_KERNELS = "its kernels live in ops/*_cuda.py and csrc/"
_PACK_VARIANT = "a QB3_PACK / QB3_SEG variant (item 16 closed): the port picks the path by shape"
_TPU_WALK = "the TPU's register-window / MXU group decode: the port takes K7 + K5 and K4"
_TBITS = "the port takes tbits in place of an output dtype"
_WORDS32 = "the port takes int32 stream words in place of u64 words"
_SWITCH = "the TPU's kernel switch"
_WINDOWS = "the port's decode_groups takes gathered windows (base, off) in place of bit positions"
_PLANES = "the TPU's lo / hi u32 planes: the port carries one int64 plane"

# (module,) a module without a counterpart, (module, name) a public function
# or class, (module, name, param) a parameter: each difference by design
EXCEPTIONS = {
    ("ops/chunkwalk_pallas.py",): "K2 " + _KERNELS,
    ("ops/encode_pallas.py",): "K8 " + _KERNELS,
    ("ops/fusedwin_pallas.py",): "K4 " + _KERNELS,
    ("ops/pack_pallas.py",): "K1, K3, K6 and K7 " + _KERNELS,
    ("ops/wavefront_pallas.py",): "K5a and K5b " + _KERNELS,
    ("ops/gather.py",): "the TPU's MXU one-hot gathers and placements: the port's are K3, K6, K7",
    ("ops/bitpack.py", "pack_symbols"): _PACK_VARIANT,
    ("ops/bitpack.py", "pack_groups_onehot"): _PACK_VARIANT,
    ("ops/bitpack.py", "pack_segmented"): _PACK_VARIANT,
    ("ops/bitpack.py", "pack_groups_pallas"): _PACK_VARIANT,
    ("ops/bitpack.py", "pack_symbols_scatter"): _PACK_VARIANT,
    ("ops/encode.py", "value_codes"):
        "the table form of value_codes_arith, which the port carries",
    ("ops/encode_image.py", "mags_planes"): _PLANES,
    ("ops/decode.py", "peek32"):
        "a bit-position gather that no qb3_tpu path calls; the port reads K7's windows",
    ("ops/decode.py", "decode_groups_regwindow"): _TPU_WALK,
    ("ops/decode.py", "decode_groups_fused"): _TPU_WALK,
    ("ops/decode.py", "reconstruct", "out_dtype"): _TBITS,
    ("ops/decode.py", "reconstruct_batch", "out_dtype"): _TBITS,
    ("ops/encode_best.py", "group_gcd", "W"): _TBITS,
    ("ops/decode_chunked.py", "decode_chunked", "words64"): _WORDS32,
    ("ops/decode_chunked.py", "decode_chunked_best", "words64"): _WORDS32,
    ("ops/decode_chunked.py", "decode_chunked_auto", "words64"): _WORDS32,
    ("ops/decode.py", "decode_indexed_narrow", "words64"): _WORDS32,
    ("ops/decode_chunked.py", "decode_chunked_auto", "use_pallas"): _SWITCH,
    ("ops/decode_chunked.py", "decode_chunked_auto", "interpret"): _SWITCH,
    ("ops/decode.py", "decode_indexed_narrow", "use_pallas"): _SWITCH,
    ("ops/decode.py", "decode_indexed_narrow", "R"): _SWITCH + " (the port's K4 takes fused=R)",
    ("ops/decode.py", "decode_groups", "words64"): _WINDOWS,
    ("ops/decode.py", "decode_groups", "val_pos"): _WINDOWS,
    ("ops/decode.py", "decode_groups", "vrung"): _WINDOWS,
    ("ops/decode.py", "decode_groups", "has_extended"): _WINDOWS + "; every kind is decoded",
    ("ops/encode_image.py", "delta_planes", "vlo"): _PLANES,
    ("ops/encode_image.py", "delta_planes", "vhi"): _PLANES,
    ("ops/encode_image.py", "step_flip_planes", "mlo"): _PLANES,
    ("ops/encode_image.py", "step_flip_planes", "mhi"): _PLANES,
    ("ops/encode_image.py", "value_lens_planes", "mlo"): _PLANES,
    ("ops/encode_image.py", "value_lens_planes", "mhi"): _PLANES,
    ("stitch.py", "scatter_stitch_shard", "axis"):
        "the port's shards run in a ShardGroup of threads, passed as group, not a mesh axis",
}


def _modules() -> list:
    out = []
    for d, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(d, f), REF).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


MODULES = _modules()


def _public(path: str) -> dict:
    """The public top-level functions and classes of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _params(fn) -> dict:
    """A function's parameter names -> the source of its default, or None."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg: None for p in pos + a.kwonlyargs}
    out.update({"*" + p.arg: None for p in (a.vararg, a.kwarg) if p is not None})
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out[p.arg] = ast.unparse(d)
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            out[p.arg] = ast.unparse(d)
    return out


def _methods(cls) -> dict:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def differences(module: str) -> dict:
    """Each difference of a module pair: its EXCEPTIONS-style key -> what
    differs."""
    port = os.path.join(PORT, module)
    if not os.path.exists(port):
        return {(module,): "no counterpart module"}
    ref, got = _public(os.path.join(REF, module)), _public(port)
    out, pairs = {}, []
    for name, node in ref.items():
        other = got.get(name)
        if other is None:
            out[(module, name)] = "no counterpart"
            continue
        if isinstance(node, ast.ClassDef) != isinstance(other, ast.ClassDef):
            out[(module, name)] = "a class in one package and a function in the other"
            continue
        if not isinstance(node, ast.ClassDef):
            pairs.append((name, node, other))
            continue
        theirs = _methods(other)
        for m, fn in _methods(node).items():
            if m.startswith("_") and m != "__init__":
                continue
            if m not in theirs:
                out[(module, f"{name}.{m}")] = "no counterpart method"
            else:
                pairs.append((f"{name}.{m}", fn, theirs[m]))
    for name, fn, other in pairs:
        want, have = _params(fn), _params(other)
        for p, default in want.items():
            if p not in have:
                out[(module, name, p)] = "no counterpart parameter"
            elif default is not None and have[p] is not None and default != have[p]:
                out[(module, name, p)] = f"default {have[p]} where qb3_tpu's is {default}"
    return out


@pytest.mark.parametrize("module", MODULES)
def test_public_surface_has_its_counterpart(module):
    bad = {k: v for k, v in differences(module).items() if k not in EXCEPTIONS}
    assert not bad, "\n".join(f"{' '.join(k)}: {v}" for k, v in sorted(bad.items()))


def test_every_exception_is_a_difference():
    """No entry of EXCEPTIONS outlives the difference it excuses."""
    found = {k for m in MODULES for k in differences(m)}
    assert not set(EXCEPTIONS) - found, sorted(set(EXCEPTIONS) - found)


def test_parity_check_sees_what_it_must(tmp_path, monkeypatch):
    """The check itself: a missing name, method, parameter or module and a
    changed default are differences; extra keywords and names are not."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    for d in (ref, port, ref / "ops", port / "ops"):
        d.mkdir()
    (ref / "m.py").write_text(
        "def f(a, b=2, *, c=None): pass\n"
        "def gone(): pass\n"
        "def _private(): pass\n"
        "class K:\n"
        "    def __init__(self, x): pass\n"
        "    def run(self, y=1): pass\n"
        "    def _helper(self): pass\n"
        "    def lost(self): pass\n")
    (port / "m.py").write_text(
        "def f(a, b=3, *, c=None, device=None): pass\n"
        "def extra(): pass\n"
        "class K:\n"
        "    def __init__(self, x, device=None): pass\n"
        "    def run(self, z=1): pass\n")
    (ref / "ops" / "n.py").write_text("def g(): pass\n")
    monkeypatch.setattr(sys.modules[__name__], "REF", str(ref))
    monkeypatch.setattr(sys.modules[__name__], "PORT", str(port))
    assert set(differences("m.py")) == {("m.py", "f", "b"), ("m.py", "gone"),
                                        ("m.py", "K.lost"), ("m.py", "K.run", "y")}
    assert differences("ops/n.py") == {("ops/n.py",): "no counterpart module"}
