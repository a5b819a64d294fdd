"""The traced run's interval arithmetic on hand-worked intervals: the
card's busy union, the pauses left out of the window, and the busy time
inside named host spans."""

from portbench import trace


def test_busy_and_gaps_clip_to_the_window():
    spans = [(0, 10), (5, 15), (20, 30), (40, 60)]
    busy, gaps = trace.busy_and_gaps(trace.merge(spans), 8, 50)
    assert busy == (15 - 8) + (30 - 20) + (50 - 40)
    assert gaps == [(15, 20), (30, 40)]


def test_segments_leave_out_the_pauses():
    assert trace.segments(0, 100, [(10, 20), (15, 30), (90, 120)]) == [[0, 10], [30, 90]]
    assert trace.segments(0, 100, []) == [[0, 100]]
    assert trace.segments(50, 100, [(0, 10)]) == [[50, 100]]


def test_overlap_of_two_interval_lists():
    device = trace.merge([(0, 10), (12, 20), (25, 40)])
    spans = trace.merge([(5, 15), (30, 50)])
    assert trace.overlap(device, spans) == (10 - 5) + (15 - 12) + (40 - 30)
    assert trace.overlap(device, []) == 0
