"""Mean host wall of one round's dispatch_from_device_buffer call, its
commits included, ms."""


def read(t):
    spans = t.spans.get("dispatch")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
