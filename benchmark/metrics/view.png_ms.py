"""view.png_ms: host milliseconds a request in the server's PNG encoder
(cli/view_server.encode_png), timed by a wrapper over the traced
window's requests."""


def read(rec):
    layer = rec.get("layer")
    return None if not layer else layer.get("png_ms")
