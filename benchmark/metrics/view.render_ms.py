"""view.render_ms: milliseconds a request in the view modes
(pipelines/viewer.render_view, which ends on the image's copy to the
host), timed by a wrapper over the traced window's requests."""


def read(rec):
    layer = rec.get("layer")
    return None if not layer else layer.get("render_ms")
