"""PyTorch port, the ctypes bindings of the CUDA kernels against their C
entries: each binding names an ``extern "C" int mmee_*`` defined in the
``csrc/<source>.cu`` that its loader builds, with one ``argtypes`` entry of
the matching kind per C parameter. Needs no ``nvcc``: ``cuda_build.load``
is replaced by a fake library that records what the loader binds."""

import ctypes
import re

import pytest

from multi_modal_early_exit_tpu_torch.ops import cuda_build
from multi_modal_early_exit_tpu_torch.ops import flash_attention as fa
from multi_modal_early_exit_tpu_torch.ops import fused_bias_attention as fba
from multi_modal_early_exit_tpu_torch.ops import kda as kd
from multi_modal_early_exit_tpu_torch.ops import layer_norm as aln
from multi_modal_early_exit_tpu_torch.ops import moe_pairs as mp
from multi_modal_early_exit_tpu_torch.ops import page_attention as pa

# (module, loader, C entry): every binding of the port
BINDINGS = [
    (fa, "_flash_attention_packed_fn", "mmee_flash_attention_packed"),
    (fa, "_train_fns", "mmee_flash_attention_packed_train_fwd"),
    (fa, "_train_fns", "mmee_flash_attention_packed_train_bwd"),
    (fa, "_headform_fns", "mmee_flash_attention_fwd"),
    (fa, "_headform_fns", "mmee_flash_attention_bwd"),
    (fa, "_tables_bwd_fn", "mmee_flash_attention_packed_train_bwd_tables"),
    (fa, "_split_fn", "mmee_split_bf16x3"),
    (fba, "_materialize_bias_fn", "mmee_materialize_bias"),
    (fba, "_table_grads_fn", "mmee_table_grads"),
    (fba, "_fused_bias_attention_fn", "mmee_fused_bias_attention"),
    (aln, "_add_layer_norm_fn", "mmee_add_layer_norm"),
    (mp, "_swiglu_weigh_fn", "mmee_swiglu_weigh"),
    (mp, "_combine_pairs_fn", "mmee_combine_pairs"),
    (pa, "_page_attention_fn", "mmee_page_attention"),
    (kd, "_kda_fn", "mmee_kda"),
    (kd, "_elementwise_fns", "mmee_short_conv"),
    (kd, "_elementwise_fns", "mmee_kda_gate"),
    (kd, "_elementwise_fns", "mmee_gated_rms_norm"),
]
LOADERS = sorted({(m, name) for m, name, _ in BINDINGS}, key=lambda x: (x[0].__name__, x[1]))


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    """Stands for a loaded library: hands out one function object per name."""

    def __init__(self, source):
        self.source = source
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _FakeFn())


def _bind_all():
    """{loader: the fake library it bound} over every loader, each called
    once with ``cuda_build.load`` faked; no fake library stays cached."""
    bound = {}
    real_load = cuda_build.load
    try:
        for module, name in LOADERS:
            loader = getattr(module, name)
            cuda_build.load = lambda source, key=(module, name): bound.setdefault(
                key, _FakeLib(source))
            loader.cache_clear()
            loader()
    finally:
        cuda_build.load = real_load
        for module, name in LOADERS:
            getattr(module, name).cache_clear()
    return bound


@pytest.fixture(scope="module")
def bound():
    """{C entry: (source, the fake function its loader bound)}."""
    return {fn_name: (lib.source, fn) for lib in _bind_all().values()
            for fn_name, fn in lib.fns.items()}


def _c_params(source: str, entry: str):
    """The parameter types of ``extern "C" int <entry>(...)`` in
    ``csrc/<source>.cu``."""
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    found = re.findall(r'extern "C" int ' + entry + r"\s*\(([^)]*)\)", text)
    assert len(found) == 1, f"{entry} is defined {len(found)} times in {source}.cu"
    params = [" ".join(p.split()) for p in found[0].split(",")]
    return [re.sub(r"\s*\w+$", "", p) for p in params]  # drop the names


def _kind_of_c(ctype: str) -> str:
    if "*" in ctype:
        return "pointer"
    return {"int": "int", "float": "float", "long long": "long long"}[ctype]


def _kind_of_ctypes(t) -> str:
    if t is ctypes.c_void_p or (isinstance(t, type) and issubclass(t, ctypes._Pointer)):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_float: "float", ctypes.c_longlong: "long long"}[t]


def test_the_bindings_are_the_list():
    """Every function a loader binds is in ``BINDINGS``, under its loader,
    and every source that a binding names is one the build compiles."""
    libs = _bind_all()
    for key, lib in libs.items():
        assert set(lib.fns) == {entry for m, n, entry in BINDINGS if (m, n) == key}, key[1]
    assert {lib.source for lib in libs.values()} == set(cuda_build.SOURCES)


@pytest.mark.parametrize("entry", [entry for _, _, entry in BINDINGS])
def test_binding_matches_its_c_entry(bound, entry):
    source, fn = bound[entry]
    assert source in cuda_build.SOURCES
    params = _c_params(source, entry)
    assert fn.argtypes is not None and fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(params), (entry, len(fn.argtypes), params)
    assert [_kind_of_ctypes(t) for t in fn.argtypes] == [_kind_of_c(p) for p in params], entry


def test_fused_bias_attention_binds_the_forward_kernels_library(bound):
    """The fused kernel is a bias source of the attention forward, so its
    entry lives in that forward's source and library, and no source of its
    own is built."""
    assert bound["mmee_fused_bias_attention"][0] == "flash_attention_packed_train"
    assert bound["mmee_flash_attention_packed"][0] == "flash_attention_packed_train"
    assert "fused_bias_attention" not in cuda_build.SOURCES
