"""Multihost bring-up logic (parallel/mesh.py) — unit-tested without a pod.

``jax.distributed.initialize`` cannot run in a single-process test
environment, so the kwarg/env fallback assembly is exercised through a
monkeypatched initialize. The degenerate single-host queries run for real.
"""
import os

import jax
import pytest

from gomel_tpu.parallel import mesh as m


def test_initialize_multihost_kwarg_assembly(monkeypatch):
    captured = {}

    def fake_initialize(**kwargs):
        captured.update(kwargs)

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    m.initialize_multihost(coordinator_address="10.0.0.1:1234",
                           num_processes=4, process_id=2)
    assert captured == {"coordinator_address": "10.0.0.1:1234",
                        "num_processes": 4, "process_id": 2}


def test_initialize_multihost_env_fallback(monkeypatch):
    """Omitted arguments are NOT passed, so jax.distributed can discover
    them under a cluster manager it knows (docs/MULTIHOST.md)."""
    captured = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: captured.update(kw))
    m.initialize_multihost()
    assert captured == {}

    captured.clear()
    m.initialize_multihost(coordinator_address="host:99")
    assert captured == {"coordinator_address": "host:99"}


def test_single_host_queries():
    assert m.is_multihost() is False
    assert m.local_device_count() == len(jax.local_devices())


def test_virtual_cpu_devices_appends_flag(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--existing_flag=1")
    m.virtual_cpu_devices(5)
    assert "--existing_flag=1" in os.environ["XLA_FLAGS"]
    assert "--xla_force_host_platform_device_count=5" in os.environ["XLA_FLAGS"]


def test_make_mesh_axis_order_places_frame_innermost():
    """Halos must ride ICI: the 'frame' axis is the fastest-varying device
    axis (docs/SCALING.md)."""
    devs = jax.devices()[:8]
    mesh = m.make_mesh(data=2, frame=4, devices=devs)
    assert mesh.axis_names == (m.DATA_AXIS, m.FRAME_AXIS)
    # consecutive devices along 'frame' for fixed 'data' coordinate
    arr = mesh.devices
    assert arr.shape == (2, 4)
    ids = [d.id for d in arr[0]]
    assert ids == sorted(ids)
