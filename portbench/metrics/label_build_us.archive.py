"""Host time building Label objects (span ``labels.build`` of
decoder/phnloop.py's labels_from_segments, its self time) a label built
(counter ``labels.built``), µs."""

from portbench.metrics._recorder import label_build_us as read  # noqa: F401
