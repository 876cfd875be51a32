"""A free loopback port for tests that must name one up front."""

import socket


def free_port() -> int:
    """A port the kernel just handed out for 127.0.0.1 (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
