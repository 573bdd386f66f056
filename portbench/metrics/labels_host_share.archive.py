"""Host wall inside label building (decoder/phnloop.py
labels_from_segments and fetch_segments_finish) over the window, %."""


def read(t):
    spans = t.spans.get("labels")
    if not spans or t.window_s <= 0:
        return None
    return 100.0 * sum(spans) / t.window_s
