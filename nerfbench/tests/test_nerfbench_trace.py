"""The trace reduction on a synthetic trace: two streams that overlap,
the window's own annotation mirrored on the device, and idle gaps named
by the host operation running then."""
import pytest

from nerfbench import trace as tr


class Ev:
    def __init__(self, name, dev, t0, t1, tid=1, annotation=False):
        self._n, self._d, self._t0, self._t1 = name, dev, t0, t1
        self._tid, self._a = tid, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._a


class Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda _self: evs})()})()


US = 1000


def synthetic():
    # window 0..1000 us; stream A busy 100-400, stream B 300-600 (overlap
    # 300-400), a kernel 900-1100 crossing the window's end; a 20 us
    # kernel at 700-720 leaves gaps 600-700 and 720-900
    return [
        Ev(tr.WINDOW, False, 0, 1000 * US),
        Ev(tr.WINDOW, True, 0, 1000 * US, annotation=True),
        Ev("kernA", True, 100 * US, 400 * US),
        Ev("kernB", True, 300 * US, 600 * US),
        Ev("kernC", True, 700 * US, 720 * US),
        Ev("kernA", True, 900 * US, 1100 * US),
        Ev("aten::item", False, 590 * US, 710 * US),
        Ev("cudaStreamSynchronize", False, 600 * US, 705 * US),
        Ev("aten::cat", False, 730 * US, 890 * US),
        Ev("other thread op", False, 0, 1000 * US, tid=2),
    ]


def test_union_counts_overlap_once_and_clips_to_the_window():
    layers = {"a": {"kernels": ["kernA"]}, "bc": {"kernels": ["kernB",
                                                            "kernC"]}}
    s = tr.summarize(Prof(synthetic()), layers)
    assert s["window_s"] == pytest.approx(1e-3)
    # 100-600 (500) + 700-720 (20) + 900-1000 (100) us
    assert s["busy_s"] == pytest.approx(620e-6)
    assert s["layer_s"]["a"] == pytest.approx(400e-6)   # 300 + 100 clipped
    assert s["layer_s"]["bc"] == pytest.approx(320e-6)
    names = dict(s["breakdown"]["device_ops"])
    assert tr.WINDOW not in names and set(names) == {"kernA", "kernB",
                                                     "kernC"}


def test_idle_gaps_named_by_the_innermost_host_operation():
    s = tr.summarize(Prof(synthetic()), {})
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 0-100: no host op of the window's thread; 600-700: the sync inside
    # aten::item; 720-900: aten::cat
    assert gaps["host outside any operation"] == pytest.approx(100e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert gaps["aten::cat"] == pytest.approx(180e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 620e-6)
    assert "other thread op" not in gaps


def test_idle_share_from_the_summary():
    from nerfbench import yardstick as y
    s = tr.summarize(Prof(synthetic()), {})
    rec = {"busy_s": s["busy_s"], "traced_s": s["window_s"]}
    assert y.idle(rec) == pytest.approx(38.0)


def device_only():
    # a device trace: marks at 0-1 and 999-1000 us; streams overlapping as
    # in synthetic(), no host events, no annotation
    return [
        Ev("at::cuda::(anonymous namespace)::spin_kernel(long)", True, 0,
           1 * US),
        Ev("kernA", True, 100 * US, 400 * US),
        Ev("kernB", True, 300 * US, 600 * US),
        Ev("kernC", True, 700 * US, 720 * US),
        Ev("at::cuda::(anonymous namespace)::spin_kernel(long)", True,
           999 * US, 1000 * US),
        Ev("kernA", True, 1500 * US, 1600 * US),
    ]


def test_a_device_only_trace_takes_its_window_from_the_marks():
    layers = {"a": {"kernels": ["kernA"]}}
    s = tr.summarize_device(Prof(device_only()), layers)
    assert s["window_s"] == pytest.approx(1e-3)
    # 100-600 + 700-720; the marks and the kernel after them not counted
    assert s["busy_s"] == pytest.approx(520e-6)
    assert s["layer_s"]["a"] == pytest.approx(300e-6)
    assert set(dict(s["breakdown"]["device_ops"])) == {"kernA", "kernB",
                                                      "kernC"}
    assert s["breakdown"]["idle_gaps"] == []
    # gaps 0-100, 600-700 and 720-1000 us, the longest first
    assert [(round(a * 1e6), round(b * 1e6)) for a, b in
            s["longest_gaps"]] == [(720, 280), (0, 100), (600, 100)]


def test_a_device_only_trace_without_marks_is_refused():
    with pytest.raises(RuntimeError):
        tr.summarize_device(Prof(synthetic()[2:]), {})
