"""Every kernel launcher of the port launches on the card that holds its
tensors.

On the CPU there is no card and no kernel library, so the tensors here are
fake CUDA tensors (``FakeTensorMode``: metadata on ``cuda:k``, no storage)
and the C entry points and the stream getter are recording stand-ins.  (A
fake CUDA tensor cannot be sliced or indexed without a CUDA build, so the
cases stop short of the views some callers take of a launcher's output.)
Each launcher, on every route it takes, must pass its tensors' device
index first to the C entry point and that device's current stream last;
together the cases reach every ``*_launch`` export of
``kernels/build.py``.  The sources must back that up: every launch entry
point takes ``int device`` first and opens a ``DeviceScope`` on it, and
each once-per-device shared-memory opt-in keys on the device it is handed,
not on the thread's current device."""
import re
import warnings

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.moe_route import moe_route as mr  # noqa: E402
from repro_torch.kernels.switch_engine import switch_engine as kw  # noqa: E402,E501
from repro_torch.kernels.switch_txn import switch_txn as tk  # noqa: E402

STREAM_BASE = 0x5000          # the stand-in stream of device d: base + d
_QUERY_SIZE = 8               # what a size query (not a launch) answers

# each launcher module, the module globals it resolves at its first launch
_RESOLVED = {tk: ("_LARGE", "_SMEM", "_GATHER", "_SCAN", "_SCAN_LARGE",
                  "_SCAN_SCRATCH", "_STREAM"),
             kw: ("_SMEM", "_PREP", "_WALK", "_SCRATCH", "_STREAM"),
             mr: ("_ROUTE", "_PLAN", "_PLANS", "_STREAM")}
LAUNCH_EXPORTS = {fn for _, exports in build.LIBRARIES.values()
                  for fn in exports if fn.endswith("_launch")}


class _Lib:
    """A loaded library's stand-in: every export of ``build.LIBRARIES``
    records (name, arguments) and answers 0, cudaSuccess, or for a size
    query a small size."""

    def __init__(self, name, calls):
        for fn in build.LIBRARIES[name][1]:
            setattr(self, fn, self._export(fn, calls))

    @staticmethod
    def _export(fn, calls):
        def call(*args):
            calls.append((fn, args))
            return 0 if fn.endswith("_launch") else _QUERY_SIZE
        return call


@pytest.fixture
def calls(monkeypatch):
    """The launch calls made, with every launcher module wired to the
    recording libraries and the stand-in stream getter, its resolved
    entry points cleared and its launch counters private to the test."""
    made = []
    libs = {name: _Lib(name, made) for name in build.LIBRARIES}
    for mod, names in _RESOLVED.items():
        monkeypatch.setattr(mod, "library", libs.__getitem__)
        monkeypatch.setattr(mod, "raw_stream",
                            lambda: lambda d: STREAM_BASE + d)
        for name in names:
            monkeypatch.setattr(mod, name, None)
        monkeypatch.setattr(mod, "LAUNCHES", dict(mod.LAUNCHES))
    with FakeTensorMode(allow_non_fake_inputs=True), \
            warnings.catch_warnings():
        # a fake tensor's data_ptr() is 0, with a deprecation warning
        warnings.simplefilter("ignore")
        yield made


def _i32(shape, d):
    return torch.zeros(shape, dtype=torch.int32, device=f"cuda:{d}")


def _launched_on(calls, d):
    """The launch exports called, each checked to have got device d and
    device d's stream; the size queries are left out."""
    names = []
    for fn, args in calls:
        if not fn.endswith("_launch"):
            continue
        assert args[0] == d, f"{fn} got device {args[0]}, tensors on {d}"
        assert args[-1] == STREAM_BASE + d, \
            f"{fn} got stream {args[-1]:#x}, not cuda:{d}'s"
        names.append(fn)
    calls.clear()
    return names


def _switch_txn_cases(d):
    regs = _i32(64, d)
    n_big = tk.SMEM_MAX_N + 8
    yield "switch_txn_call", lambda: tk.switch_txn_call(
        regs, _i32(10, d), _i32(10, d), _i32(10, d)), ["switch_txn_launch"]
    yield "result_gather_call", lambda: tk.result_gather_call(
        _i32(16, d), _i32(4, d)), ["result_gather_launch"]
    yield "switch_txn_gather_call", lambda: tk.switch_txn_gather_call(
        regs, *(_i32(32, d) for _ in range(4)), 8, _i32(5, d)), \
        ["switch_txn_smem_launch"]
    yield "switch_txn_gather_call, large N", \
        lambda: tk.switch_txn_gather_call(
            regs, *(_i32(n_big, d) for _ in range(4)), 8, _i32(5, d)), \
        ["switch_txn_launch", "result_gather_launch"]
    yield "scan_prune_gather_packed", lambda: tk.scan_prune_gather_packed(
        regs, _i32(40, d), 0, 9, 4), ["scan_prune_launch"]
    yield "scan_prune_gather_packed, large M", \
        lambda: tk.scan_prune_gather_packed(
            _i32(tk.SCAN_SMEM_MAX + 1, d), None, 0, 9, 4), \
        ["scan_prune_large_launch"]


def _walk_cases(d):
    regs = _i32((4, 16), d)
    for mode in kw.MODES:
        yield f"switch_walk_gather_call[{mode}]", \
            lambda mode=mode: kw.switch_walk_gather_call(
                mode, regs, *(_i32((8, 4), d) for _ in range(4)),
                _i32(6, d)), ["switch_walk_smem_launch"]
    big = (kw.WALK_SMEM_MAX // 4 + 1, 4)
    yield "switch_walk_gather_call, large route", \
        lambda: kw.switch_walk_gather_call(
            "serial", regs, *(_i32(big, d) for _ in range(4)), _i32(6, d)), \
        ["switch_walk_prep_launch", "switch_walk_launch",
         "result_gather_launch"]


def _moe_cases(d):
    yield "moe_route_call", lambda: mr.moe_route_call(_i32(32, d)), \
        ["moe_route_launch"]
    yield "route_plan_call", lambda: mr.route_plan_call(
        _i32(64, d), 16, 8, 2), ["moe_plan_launch"]
    yield "route_plan_call, batched", lambda: mr.route_plan_call(
        _i32((3, 64), d), 16, 8, 2), ["moe_plan_streams_launch"]


@pytest.mark.parametrize("cases", [_switch_txn_cases, _walk_cases,
                                   _moe_cases],
                         ids=["switch_txn", "switch_engine", "moe_route"])
@pytest.mark.parametrize("d", [0, 1, 3])
def test_every_launcher_launches_on_its_tensors_card(calls, cases, d):
    """Each route of each launcher passes its tensors' device index and
    that device's stream, whatever card the tensors are on."""
    for what, run, want in cases(d):
        run()
        assert _launched_on(calls, d) == want, what


def test_the_cases_reach_every_launch_export(calls):
    """Together the cases call every ``*_launch`` of every library."""
    seen = set()
    for cases in (_switch_txn_cases, _walk_cases, _moe_cases):
        for _, run, _ in cases(2):
            run()
            seen |= set(_launched_on(calls, 2))
    # moe_plan_launch forwards to moe_plan_streams_launch in C; Python
    # calls each for its own shape
    assert seen == LAUNCH_EXPORTS


def _c_functions(text):
    """{name: (parameters, body)} of the ``extern "C"`` block's int
    functions."""
    block = text[text.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^int (\w+)\(([^)]*)\) \{\n(.*?)^\}", block,
                         re.M | re.S):
        out[m.group(1)] = (m.group(2), m.group(3))
    return out


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_launch_entry_points_open_a_device_scope(name):
    """Every ``*_launch`` takes ``int device`` first and makes it current
    before it launches (a ``DeviceScope``, or a call to another entry
    point with the same device); its ctypes binding takes an int first;
    the shared-memory opt-in keys on the device it is handed; the source
    includes the shared header that ``build.HEADERS`` hashes into the
    library's name."""
    source, exports = build.LIBRARIES[name]
    text = source.read_text()
    assert '#include "../../csrc/device_scope.cuh"' in text
    assert any(h.name == "device_scope.cuh" and h.exists()
               for h in build.HEADERS)
    funcs = _c_functions(text)
    launches = [fn for fn in exports if fn.endswith("_launch")]
    assert launches
    for fn in launches:
        params, body = funcs[fn]
        assert params.split(",")[0].split() == ["int", "device"], fn
        assert exports[fn][0] is build._ci, fn
        opens = body.find("const DeviceScope scope(device);")
        forwards = re.search(r"\w+_launch\(device,", body)
        launch = body.find("<<<")
        assert opens >= 0 or forwards, f"{fn} opens no DeviceScope"
        if opens >= 0:
            checked = body.find("scope.status()")
            assert opens < checked, fn
            assert launch < 0 or checked < launch, fn
    # the opt-in bit is the handed device's, never cudaGetDevice's
    assert "cudaGetDevice" not in text
    for m in re.finditer(r"configured\.load\(\) & bit", text):
        head = text[:m.start()]
        assert "const unsigned bit = 1u << (dev & 31);" in \
            head[head.rindex("static std::atomic<unsigned> configured"):]
