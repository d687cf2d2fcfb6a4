"""The statistics: the 95th percentile is taken over every chunk, the
busy time is the union of the device intervals, idle gaps are named by
the host spans open in them."""
import statistics

from benchmark import run, trace


def test_p95_over_all_chunks():
    lat = [float(i) for i in range(1, 201)]
    assert run.p95(lat) == statistics.quantiles(lat, n=100,
                                                method="inclusive")[94]
    assert 189.0 < run.p95(lat) < 191.0
    assert run.p95([4.0]) == 4.0


def test_busy_union_and_gaps():
    t = trace.Trace(window=(0.0, 10.0))
    t.device = [(1.0, 3.0, "a"), (2.0, 4.0, "b"), (6.0, 7.0, "a"),
                (9.5, 12.0, "c"), (-1.0, 0.5, "d")]
    t.spans = [(4.0, 5.5, "dispatch"), (5.0, 6.0, "upload")]
    assert t.busy() == [[0.0, 0.5], [1.0, 4.0], [6.0, 7.0], [9.5, 10.0]]
    assert t.busy_s() == 0.5 + 3.0 + 1.0 + 0.5
    assert t.by_name() == {"a": 3.0, "b": 2.0, "c": 0.5, "d": 0.5}
    assert t.gaps() == [("no host span", 2.5), ("dispatch+upload", 2.0),
                        ("no host span", 0.5)]
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["a", 3.0]
    assert b["idle_gaps"][0][1] == 2.5
