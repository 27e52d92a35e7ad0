"""The trace reduction: busy time as a union, idle gaps named by the host,
launches matched by correlation id, the session's lead left out."""

from torch.autograd import DeviceType

from harness import trace as tr


class Ev:
    def __init__(self, name, start, dur, dev, corr=0, annot=False):
        self._n, self._s, self._d, self._dev, self._c, self._a = name, start, dur, dev, corr, annot

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def test_union_and_gaps():
    assert tr.merge_intervals([(5, 9), (0, 2), (1, 3), (8, 12)]) == [(0, 3), (5, 12)]
    assert tr.gaps([(2, 3), (5, 12)], 0, 15) == [(0, 2), (3, 5), (12, 15)]
    assert tr.clip([(0, 3), (5, 12)], 1, 6) == [(1, 3), (5, 6)]


def test_analyse(monkeypatch):
    monkeypatch.setattr(tr, "LEAD", 1)
    ev = [Ev("cudaLaunchKernel", 0, 1, CPU, corr=1), Ev("lead", 1, 1, CUDA, corr=1),
          Ev(tr.WINDOW_RANGE, 100, 1000, CPU),
          Ev("bench.fetch", 300, 400, CPU),
          Ev("cudaLaunchKernel", 110, 5, CPU, corr=2), Ev("k", 120, 100, CUDA, corr=2),
          Ev("cudaMemcpyAsync", 200, 5, CPU, corr=3), Ev("Memcpy DtoH", 200, 50, CUDA, corr=3),
          Ev("cudaLaunchKernel", 800, 5, CPU, corr=4), Ev("k", 900, 300, CUDA, corr=4)]
    t = tr.analyse(ev)
    assert t.window_s == 1e-6
    assert t.busy_s * 1e9 == (250 - 120) + (1100 - 900)  # clipped at the window's end
    assert t.host_ops == 3
    assert t.ops_by_name["k"] == (300e-9, 2)
    assert t.idle_gaps[0] == ["bench.fetch", 650e-9]  # 250..900, inside bench.fetch
    assert t.device_ops()[0][0] == "k"
    assert tr.analyse(ev[:2]).window_s == 0.0  # no window: nothing to read
