"""DAX service manager: runs controller + computers + queryer in one
process with a shared storage directory (reference: dax/service_manager.go:23
— controller/queryer/N computers behind one mux for dev/test; `featurebase
dax` command cmd/dax.go).

Own copy of featurebase_tpu/dax/service.py.  Every computer and the queryer
is an API on `device`: the card unless the caller passes "cpu"; without
CUDA and without that request the service raises before it starts a
server.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional

from featurebase_tpu_torch.dax.computer import DaxComputerAPI
from featurebase_tpu_torch.dax.controller import Controller
from featurebase_tpu_torch.dax.queryer import DaxQueryerAPI
from featurebase_tpu_torch.dax.storage import ResourceManager, Snapshotter, \
    Writelogger
from featurebase_tpu_torch.executor.executor import resolve_device
from featurebase_tpu_torch.server.http_server import Server


class DaxService:
    """In-process DAX deployment; index [i] → computer API, .queryer for the
    front-end."""

    def __init__(self, n_computers: int = 2, data_dir: Optional[str] = None,
                 poll_interval: float = 0.5,
                 snapshot_interval: float = 0.0, device=None):
        self.device = resolve_device(device)
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="dax-")
        wl = Writelogger(os.path.join(self.data_dir, "writelogger"))
        snap = Snapshotter(os.path.join(self.data_dir, "snapshotter"))
        self.resources = ResourceManager(wl, snap)

        self.controller = Controller(
            data_dir=os.path.join(self.data_dir, "controller"))
        self.controller_server = Server(api=self.controller).start()
        self.controller_uri = self.controller_server.url

        self.computers: List[DaxComputerAPI] = []
        self.computer_servers: List[Server] = []
        for _ in range(n_computers):
            self.add_computer()

        self.controller.start_poller(poll_interval)
        if snapshot_interval:
            self.controller.start_snapping_turtle(snapshot_interval)

        self.queryer = DaxQueryerAPI(self.controller_uri, device=self.device)
        self.queryer_server = Server(api=self.queryer).start()

    def add_computer(self) -> DaxComputerAPI:
        i = len(self.computers)
        c = DaxComputerAPI(f"computer{i}", self.controller_uri,
                           self.resources, device=self.device)
        s = Server(api=c).start()
        self.computers.append(c)
        self.computer_servers.append(s)
        c.register(s.url)
        return c

    def stop_computer(self, i: int):
        self.computer_servers[i].stop()

    def __getitem__(self, i: int) -> DaxComputerAPI:
        return self.computers[i]

    def close(self):
        self.controller.stop()
        for s in self.computer_servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001
                pass
        try:
            self.queryer_server.stop()
        except Exception:  # noqa: BLE001
            pass
        self.controller_server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
