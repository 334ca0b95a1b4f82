"""Admin socket: per-daemon unix-socket JSON command server (port of
ceph_tpu/common/admin_socket.py).

Reference parity: AdminSocket
(Ceph's src/common/admin_socket.cc): a listener thread on a unix
domain socket; requests are a NUL-terminated command (JSON
`{"prefix": "...", ...}` or a bare legacy string); responses are a 4-byte
network-order length followed by the payload — the same wire format, so
`ceph daemon <sock> <cmd>`-style clients carry over.  Built-in commands:
help, version, perf dump, perf schema, config get/set/show/diff.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

Handler = Callable[[Dict[str, Any]], Any]


class AdminSocket:
    def __init__(self, path: str, config=None, perf=None,
                 version: str = "ceph_tpu"):
        self.path = path
        self._config = config
        self._perf = perf
        self._version = version
        self._handlers: Dict[str, Tuple[str, Handler]] = {}
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._register_builtins()

    # -- command registry -------------------------------------------------

    def register_command(self, prefix: str, handler: Handler,
                         help_: str = "") -> int:
        if prefix in self._handlers:
            return -17  # EEXIST
        self._handlers[prefix] = (help_, handler)
        return 0

    def unregister_command(self, prefix: str) -> None:
        self._handlers.pop(prefix, None)

    def _register_builtins(self) -> None:
        self.register_command(
            "help", lambda cmd: {p: h for p, (h, _f) in
                                 sorted(self._handlers.items())},
            "list available commands")
        self.register_command(
            "version", lambda cmd: {"version": self._version},
            "get version")
        if self._perf is not None:
            self.register_command(
                "perf dump", lambda cmd: self._perf.dump(
                    cmd.get("logger") or cmd.get("var", "")),
                "dump perfcounters value")
            self.register_command(
                "perf schema", lambda cmd: self._perf.schema(),
                "dump perfcounters schema")
        if self._config is not None:
            self.register_command(
                "config show", lambda cmd: self._config.show_config(),
                "dump current config settings")
            self.register_command(
                "config diff", lambda cmd: self._config.diff(),
                "dump diff of current config and default config")
            self.register_command(
                "config get",
                lambda cmd: {cmd["var"]: self._config.get(cmd["var"])},
                "config get <field>: get the config value")

            def _config_set(cmd):
                self._config.set_val(cmd["var"], cmd["val"])
                return {"success": ""}

            self.register_command(
                "config set", _config_set,
                "config set <field> <val>: set a config variable")

    # -- server -----------------------------------------------------------

    def init(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(
            target=self._serve, name="admin_socket", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._shutdown = True
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self._sock is not None:
            self._sock.close()
        if os.path.exists(self.path):
            os.unlink(self.path)

    def _serve(self) -> None:
        while not self._shutdown:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._handle_conn(conn)
            except Exception:
                pass
            finally:
                conn.close()

    def _handle_conn(self, conn: socket.socket) -> None:
        conn.settimeout(5.0)
        raw = bytearray()
        while True:
            b = conn.recv(1)
            if not b or b == b"\0":
                break
            raw += b
            if len(raw) > 1024:
                break
        response = self._dispatch(bytes(raw).decode("utf-8", "replace"))
        payload = json.dumps(response, indent=4,
                             default=str).encode() + b"\n"
        conn.sendall(struct.pack("!I", len(payload)) + payload)

    def _dispatch(self, request: str) -> Any:
        request = request.strip()
        try:
            cmd = json.loads(request) if request.startswith("{") else {
                "prefix": request}
        except json.JSONDecodeError:
            cmd = {"prefix": request}
        prefix = cmd.get("prefix", "")
        # longest-prefix match so "perf dump" beats "perf"
        best = ""
        for registered in self._handlers:
            if (prefix == registered or
                    prefix.startswith(registered + " ")) and \
                    len(registered) > len(best):
                best = registered
        if not best:
            return {"error": f"unknown command {prefix!r};"
                    " try 'help'"}
        # legacy form: "config get name" as a bare string
        tail = prefix[len(best):].strip()
        if tail and "var" not in cmd:
            parts = tail.split()
            cmd["var"] = parts[0]
            if len(parts) > 1:
                cmd["val"] = " ".join(parts[1:])
        try:
            return self._handlers[best][1](cmd)
        except KeyError as e:
            return {"error": f"missing/unknown field {e}"}
        except Exception as e:
            return {"error": str(e)}


def admin_socket_request(path: str, command: Any, timeout: float = 5.0
                         ) -> Any:
    """Client side (AdminSocketClient::do_request)."""
    payload = (json.dumps(command) if isinstance(command, dict)
               else str(command)).encode() + b"\0"
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        s.sendall(payload)
        header = b""
        while len(header) < 4:
            chunk = s.recv(4 - len(header))
            if not chunk:
                raise ConnectionError("short admin socket response header")
            header += chunk
        (length,) = struct.unpack("!I", header)
        body = b""
        while len(body) < length:
            chunk = s.recv(length - len(body))
            if not chunk:
                break
            body += chunk
    return json.loads(body)
