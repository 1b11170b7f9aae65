"""Port parity: the node configs (``hypha_tpu_torch/config.py``,
``node_config.py``) against the JAX package's.

1. ``init`` writes the same TOML for every role in both packages, but for
   the accelerator keys (the port sells ``gpu``: ``job.worker_gpu`` beside
   a ``job.worker_tpu`` that must stay 0, ``resources.tpu`` documented as
   such), the executor runtime's doc line and the executor's command (the
   port's names its trainer CLI, the reference's is empty).
2. The same TOML file, ``HYPHA_*`` environment and ``--set`` overrides
   build equal sections with equal provenance in both packages.
3. Bad input raises the same ``ConfigError`` text with the same provenance.
4. Each option outside the port's slice, which the JAX package accepts,
   raises ``NotImplementedError`` naming its ROADMAP.md label; the CLI
   exits 2 on it.
5. The node-plane options (``[tls]``, ``network.mux``, ``executor.cmd`` /
   ``executor.args``) validate, reach the node ``cli._make_node`` builds
   as the JAX CLI's reach its node, and the process executor spawns the
   named command with the reference's substitutions.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch

from hypha_tpu import cli as jcli
from hypha_tpu import config as jcfg
from hypha_tpu import messages as jmsg
from hypha_tpu import node_config as jnc
from hypha_tpu_torch import cli as tcli
from hypha_tpu_torch import config as tcfg
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch import node_config as tnc
from hypha_tpu_torch.resources import Resources

ROLES = ("gateway", "data", "worker", "scheduler")
SCHEMA = {"gateway": "GatewayConfig", "data": "DataNodeConfig", "worker": "WorkerConfig",
          "scheduler": "SchedulerConfig"}
# Keys whose lines (and doc comments) differ: the accelerator axis, the
# runtime doc, which names the JAX trainer in the JAX package, and the
# executor's command, which names the port's trainer CLI in the port.
ACCELERATOR = ("worker_tpu", "worker_gpu", "tpu", "gpu", "runtime", "cmd", "args")


@pytest.fixture(autouse=True)
def _no_hypha_env(monkeypatch):
    for var in list(os.environ):
        if var.startswith("HYPHA_"):
            monkeypatch.delenv(var)


def _without_accelerator(text: str) -> list:
    """The TOML's lines minus each accelerator key and the doc comment
    right above it."""
    lines = text.splitlines()
    out = []
    for i, line in enumerate(lines):
        key = line.split("=")[0].strip()
        nxt = lines[i + 1].split("=")[0].strip() if i + 1 < len(lines) else ""
        if key in ACCELERATOR or (line.startswith("#") and nxt in ACCELERATOR):
            continue
        out.append(line)
    return out


@pytest.mark.parametrize("role", ROLES)
def test_init_writes_the_jax_packages_file_but_the_accelerator_keys(role, tmp_path, capsys):
    paths = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        paths[name] = tmp_path / f"{name}.toml"
        assert cli.main([role, "init", "-o", str(paths[name]), "--name", "n1"]) == 0
    jtext, ttext = (paths[k].read_text() for k in ("jax", "port"))
    assert _without_accelerator(ttext) == _without_accelerator(jtext)
    assert 'name = "n1"' in ttext
    if role == "scheduler":
        assert "worker_tpu = 0.0" in ttext and "worker_gpu = 1.0" in ttext
        assert "worker_tpu = 1.0" in jtext and "worker_gpu" not in jtext
        job = tcfg.builder(tnc.SchedulerConfig).with_toml(paths["port"]).build().value.job
        assert job.worker_resources() == Resources(gpu=1.0, cpu=1.0, memory=100.0)
    if role == "worker":
        assert "tpu = 0.0" in ttext and "gpu = 0.0" in ttext
        assert 'cmd = ""' in jtext and 'cmd = "python3"' in ttext
        executor = tcfg.builder(tnc.WorkerConfig).with_toml(paths["port"]).build().value.executor
        assert (executor.cmd, executor.args) == (tnc.TRAINER_CMD, tnc.TRAINER_ARGS)


def _layers(role: str, tmp_path, monkeypatch) -> dict:
    """(TOML text, env, overrides) valid in both packages for ``role``."""
    data = tmp_path / "slices"
    data.mkdir(exist_ok=True)
    cases = {
        "gateway": ('name = "gw"\n[network]\nlisten = ["127.0.0.1:7000"]\n'
                    'exclude_cidrs = ["10.0.0.0/8"]\n',
                    {"HYPHA_NETWORK__RELAY": "false"}, {"network.external": ["1.2.3.4:7000"]}),
        "data": (f'[datasets]\ncounting = "{data}"\n[network]\ngateways = ["127.0.0.1:7000"]\n',
                 {"HYPHA_NAME": "d1"}, {"telemetry.sample_ratio": 0.5}),
        "worker": ('work_root = "/tmp/w"\n[resources]\ngpu = 1.0\ncpu = 8\n'
                   '[offer]\nstrategy = "whole"\nprice = 2.5\n'
                   '[executor]\nruntime = "process"\ncmd = "/usr/bin/python3"\n'
                   'args = ["-m", "trainer", "--socket", "{SOCKET_PATH}"]\n',
                   {"HYPHA_OFFER__FLOOR": "0.5", "HYPHA_RESOURCES__MEMORY": "65536"},
                   {"multihost.process_id": 0, "name": "w0"}),
        "scheduler": ('[job]\nkind = "serve"\nserve_name = "llama7b"\nmodel_family = "llama"\n'
                      'model_preset = "llama2-7b"\nmodel_type = "causal-lm"\n'
                      'serve_block_size = 16\nserve_ragged = true\nworker_tpu = 0.0\n',
                      {"HYPHA_JOB__SERVE_MAX_BATCH": "8", "HYPHA_JOB__SERVE_MAX_NEW_TOKENS": "64"},
                      {"job.model_seed": 3, "status_bridge": "127.0.0.1:9000"}),
        "scheduler-train": ('[job]\nmodel_family = "llama"\nmodel_preset = "tiny"\n'
                            'model_type = "causal-lm"\ndataset = "counting"\nworker_tpu = 0.0\n'
                            '[job.model_config]\ndtype = "float32"\n',
                            {"HYPHA_JOB__UPDATE_ROUNDS": "2", "HYPHA_JOB__NUM_WORKERS": "1"},
                            {"job.lr_schedule": "cosine-with-warmup", "job.warmup_steps": 4}),
    }
    toml, env, over = cases[role]
    path = tmp_path / f"{role}.toml"
    path.write_text(toml)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return dict(path=path, over=over)


def _build(cfg_mod, nc_mod, role, path, over):
    cls = getattr(nc_mod, SCHEMA[role.split("-")[0]])
    return cfg_mod.builder(cls).with_toml(path).with_env("HYPHA_").with_overrides(over).build()


@pytest.mark.parametrize("role", ["gateway", "data", "worker", "scheduler", "scheduler-train"])
def test_same_layers_build_equal_sections(role, tmp_path, monkeypatch):
    lay = _layers(role, tmp_path, monkeypatch)
    built = {k: _build(c, n, role, lay["path"], lay["over"]).validate()
             for k, c, n in (("jax", jcfg, jnc), ("port", tcfg, tnc))}
    jv, tv = dataclasses.asdict(built["jax"].value), dataclasses.asdict(built["port"].value)
    if "job" in tv:
        assert tv["job"].pop("worker_gpu") == 1.0
    assert tv == jv
    tmeta = {k: v for k, v in built["port"].metadata.items() if k != "job.worker_gpu"}
    assert tmeta == {k: tnc_prov(v) for k, v in built["jax"].metadata.items()}
    sources = {p.source for p in tmeta.values()}
    assert {"default", "cli", f"file:{lay['path']}"} <= sources
    assert any(s.startswith("env:HYPHA_") for s in sources)
    if role == "scheduler-train":
        job = built["port"].value.job.to_job()
        assert job.resources.worker == Resources(gpu=1.0, cpu=1.0, memory=100.0)
        assert job.rounds.update_rounds == 2 and job.lr_scheduler.warmup_steps == 4


def tnc_prov(p):
    return tcfg.Provenance(p.key, p.source)


# (role, TOML text or None, env, overrides) that both packages refuse alike.
BAD = {
    "unknown key": ("gateway", None, {}, {"nonsense": 1}),
    "not a float (cli)": ("worker", None, {}, {"resources.cpu": "lots"}),
    "not a float (env)": ("worker", None, {"HYPHA_OFFER__PRICE": "cheap"}, {}),
    "not a float (file)": ("worker", "[offer]\nprice = \"x\"\n", {}, {}),
    "not a bool": ("gateway", None, {"HYPHA_NETWORK__RELAY": "maybe"}, {}),
    "not a table": ("worker", "offer = 3\n", {}, {}),
    "offer strategy": ("worker", None, {}, {"offer.strategy": "cheap"}),
    "executor runtime": ("worker", None, {}, {"executor.runtime": "docker"}),
    "nothing to sell": ("worker", None, {}, {"resources.cpu": 0, "resources.memory": 0}),
    "half a pod": ("worker", None, {}, {"multihost.num_processes": 2}),
    "telemetry protocol": ("gateway", None, {}, {"telemetry.protocol": "grpc"}),
    "sample ratio": ("data", None, {}, {"datasets": {"d": "/tmp"}, "telemetry.sample_ratio": 2}),
    "no datasets": ("data", None, {}, {}),
    "tls file": ("gateway", None, {}, {"tls.cert": "/nonexistent/cert.pem"}),
    "job kind": ("scheduler", None, {}, {"job.kind": "both"}),
    "model type": ("scheduler", None, {}, {"job.model_type": "telepathy"}),
    "serve name": ("scheduler", None, {}, {"job.kind": "serve"}),
    "serve tokens": ("scheduler", None, {}, {"job.kind": "serve", "job.serve_name": "s",
                                             "job.serve_max_new_tokens": 0}),
    "ragged needs paging": ("scheduler", None, {}, {"job.kind": "serve", "job.serve_name": "s",
                                                    "job.serve_ragged": True}),
    "kv quant": ("scheduler", None, {}, {"job.kind": "serve", "job.serve_name": "s",
                                         "job.serve_kv_quant": "fp4"}),
    "quorum": ("scheduler", None, {}, {"job.quorum_fraction": 2.0}),
    "codec": ("scheduler", None, {}, {"job.delta_codec": "zip"}),
    "sync mode": ("scheduler", None, {}, {"job.sync_mode": "eventual"}),
    "prefetch": ("scheduler", None, {}, {"job.prefetch_slices": 2}),
    "lr schedule": ("scheduler", None, {}, {"job.lr_schedule": "sawtooth"}),
    "attempts": ("scheduler", None, {}, {"job.max_attempts": 0}),
    "process without cmd": ("worker", None, {}, {"executor.runtime": "process",
                                                 "executor.cmd": ""}),
    "missing file": ("gateway", "MISSING", {}, {}),
    "bad toml": ("gateway", "name = \n", {}, {}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_input_raises_the_same_config_error(case, tmp_path, monkeypatch):
    role, toml, env, over = BAD[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    errors = {}
    for name, c, n in (("jax", jcfg, jnc), ("port", tcfg, tnc)):
        b = c.builder(getattr(n, SCHEMA[role]))
        with pytest.raises(c.ConfigError) as info:
            if toml == "MISSING":
                b.with_toml(tmp_path / "absent.toml")
            elif toml is not None:
                path = tmp_path / "c.toml"
                path.write_text(toml)
                b.with_toml(path)
            b.with_env("HYPHA_").with_overrides(over).build().validate()
        errors[name] = info.value
    assert str(errors["port"]) == str(errors["jax"])
    jp, tp = errors["jax"].provenance, errors["port"].provenance
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert (tp.key, tp.source) == (jp.key, jp.source)


@pytest.mark.parametrize("key", ["resources.tpu", "job.worker_tpu"])
def test_tpu_axis_is_refused_with_the_gpu_key(key):
    role = "worker" if key.startswith("resources") else "scheduler"
    b = tcfg.builder(getattr(tnc, SCHEMA[role])).with_overrides({key: 1.0}).build()
    with pytest.raises(tcfg.ConfigError, match="the port sells gpu") as info:
        b.validate()
    assert ("resources.gpu" if role == "worker" else "job.worker_gpu") in str(info.value)


SERVE = {"job.kind": "serve", "job.serve_name": "s", "job.serve_block_size": 16}
# (role, overrides, ROADMAP.md label); "<file>" stands for an existing file.
UNPORTED = {
    "multihost": ("worker", {"multihost.coordinator_address": "10.0.0.1:1234",
                             "multihost.num_processes": 2}, "Parallel and long context"),
    "sharding": ("scheduler", {"job.sharding": {"tp": 2}}, "intra-replica sharding"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_option_raises_with_its_label(case, tmp_path):
    role, over, label = UNPORTED[case]
    pem = tmp_path / "x.pem"
    pem.write_text("-")
    over = {k: (str(pem) if v == "<file>" else v) for k, v in over.items()}
    if role == "scheduler":
        over.setdefault("job.worker_tpu", 0.0)
    jbuilt = jcfg.builder(getattr(jnc, SCHEMA[role])).with_overrides(over).build()
    jbuilt.validate()  # the JAX package runs it
    tbuilt = tcfg.builder(getattr(tnc, SCHEMA[role])).with_overrides(over).build()
    with pytest.raises(NotImplementedError, match=label):
        tbuilt.validate()


# Serve options refused until speculative decoding and the fixed-slot pool
# were ported.
SERVE_PORTED = {
    "spec ngram": {**SERVE, "job.serve_spec_ngram": 3},
    "spec draft": {**SERVE, "job.serve_spec_draft": 2},
    "spec layers": {**SERVE, "job.serve_spec_layers": 1},
    "fixed-slot pool": {**SERVE, "job.serve_block_size": 0},
}


@pytest.mark.parametrize("case", sorted(SERVE_PORTED))
def test_serve_spec_and_fixed_slot_options_are_accepted(case):
    """Each validates in both packages and builds the same job section."""
    over = {**SERVE_PORTED[case], "job.worker_tpu": 0.0}
    jbuilt = jcfg.builder(jnc.SchedulerConfig).with_overrides(over).build()
    tbuilt = tcfg.builder(tnc.SchedulerConfig).with_overrides(over).build()
    jbuilt.validate()
    tbuilt.validate()
    jj, tj = jbuilt.value.job, tbuilt.value.job
    keys = ("serve_spec_ngram", "serve_spec_draft", "serve_spec_layers", "serve_block_size")
    assert {k: getattr(tj, k) for k in keys} == {k: getattr(jj, k) for k in keys}


@pytest.mark.parametrize("role", ["gateway", "data", "worker", "scheduler"])
def test_telemetry_endpoint_is_accepted_as_the_reference_accepts_it(role):
    """``telemetry.endpoint`` (refused until tracing was ported) builds the
    same validated section in both packages for every role; the export it
    turns on is tested in ``tests/test_torch_telemetry.py``."""
    over = {"telemetry.endpoint": "http://127.0.0.1:4318", "telemetry.sample_ratio": 0.5,
            "telemetry.attributes": {"deployment": "dev"}}
    if role == "data":
        over["datasets"] = {"d": "/tmp"}
    if role == "scheduler":
        over["job.worker_tpu"] = 0.0
    jbuilt = jcfg.builder(getattr(jnc, SCHEMA[role])).with_overrides(over).build()
    tbuilt = tcfg.builder(getattr(tnc, SCHEMA[role])).with_overrides(over).build()
    jbuilt.validate()
    tbuilt.validate()
    jt, tt = jbuilt.value.telemetry, tbuilt.value.telemetry
    assert (tt.endpoint, tt.protocol, tt.sample_ratio, tt.attributes) == \
        (jt.endpoint, jt.protocol, jt.sample_ratio, jt.attributes)


# Elastic rounds, a checkpoint_dir, the input pipeline and the metrics plane
# with its SLO rules, each with stream sync: both packages validate the
# section and build the same job (bytes equal but for the accelerator key of
# the resources: the port sells gpu).
LIFTED = {
    "quorum": {"job.quorum_fraction": 0.5, "job.sync_mode": "stream"},
    "checkpoint": {"job.checkpoint_dir": "/tmp/ck", "job.sync_mode": "stream"},
    "input pipeline": {"job.input_pipeline": True, "job.prefetch_slices": 3,
                       "job.sync_mode": "stream"},
    "metrics plane": {"job.metrics_plane": True, "job.metrics_interval_s": 0.5,
                      "job.metrics_dir": "/tmp/m", "job.sync_mode": "stream"},
    "slo rules": {"job.metrics_plane": True, "job.sync_mode": "stream",
                  "job.slo_rules": ["round_wall_s <= 30", "silent_s <= 15",
                                    "hypha.serve.request_latency_ms.p99 <= 250 @peer"]},
}


@pytest.mark.parametrize("case", sorted(LIFTED))
def test_lifted_option_validates_and_builds_the_reference_job(case):
    over = {**LIFTED[case], "job.worker_tpu": 0.0}
    jbuilt = jcfg.builder(getattr(jnc, SCHEMA["scheduler"])).with_overrides(over).build()
    tbuilt = tcfg.builder(getattr(tnc, SCHEMA["scheduler"])).with_overrides(over).build()
    jbuilt.validate()
    tbuilt.validate()
    tjob_, jjob_ = tbuilt.value.job.to_job(), jbuilt.value.job.to_job()
    for job in (tjob_, jjob_):
        job.resources = None
    assert tmsg.encode(tjob_) == jmsg.encode(jjob_)
    assert tjob_.sync_mode == "stream"


def test_serve_metrics_plane_validates_as_the_reference():
    """A serve deployment with the metrics plane and its rules: both
    packages validate the section and read the same values."""
    over = {**SERVE, "job.metrics_plane": True, "job.metrics_dir": "/tmp/m",
            "job.slo_rules": ["silent_s <= 3"], "job.worker_tpu": 0.0}
    got = []
    for cfg_mod, nc in ((jcfg, jnc), (tcfg, tnc)):
        built = cfg_mod.builder(getattr(nc, SCHEMA["scheduler"])).with_overrides(over).build()
        built.validate()
        job = built.value.job
        got.append((job.metrics_plane, job.metrics_interval_s, job.metrics_dir, job.slo_rules))
    assert got[0] == got[1] == (True, 1.0, "/tmp/m", ["silent_s <= 3"])


@pytest.mark.parametrize("rule", ["no operator here", "metric <= notanumber", "<= 3",
                                  ".p99 <= 3"])
def test_bad_slo_rule_gives_the_reference_config_error(rule):
    """A bad rule fails validation with the reference's ``ConfigError``
    text in both packages."""
    over = {"job.metrics_plane": True, "job.slo_rules": [rule], "job.worker_tpu": 0.0}
    texts = []
    for cfg_mod, nc in ((jcfg, jnc), (tcfg, tnc)):
        built = cfg_mod.builder(getattr(nc, SCHEMA["scheduler"])).with_overrides(over).build()
        with pytest.raises(cfg_mod.ConfigError) as info:
            built.validate()
        texts.append(str(info.value))
    assert texts[0] == texts[1] and texts[1].startswith("job.slo_rules: SLO rule")


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """root -> org-a -> n1, with a CRL, from the port's certutil."""
    from hypha_tpu_torch import certutil

    out = tmp_path_factory.mktemp("pki")
    for args in (["root"], ["org", "--name", "org-a"], ["node", "--org", "org-a", "--name", "n1"],
                 ["node", "--org", "org-a", "--name", "gone"],
                 ["revoke", "--org", "org-a", "--cert", str(out / "gone.crt")]):
        assert certutil.main([args[0], "--out", str(out), *args[1:]]) == 0
    return out


def _tls(pki, crls: bool) -> dict:
    tls = {"tls.cert": str(pki / "n1.crt"), "tls.key": str(pki / "n1.key"),
           "tls.trust": str(pki / "trust.crt")}
    return {**tls, "tls.crls": str(pki / "org-a.crl")} if crls else tls


# The spawned command writes what it was given: its arguments and the
# environment the executor exports.
_ECHO = ("import json, os, sys; json.dump({'argv': sys.argv[1:], 'env': {k: os.environ.get(k) "
         "for k in ('SOCKET_PATH', 'WORK_DIR', 'JOB_JSON', 'DEVICE')}}, open(%r, 'w'))")
_PLACEHOLDERS = ["{SOCKET_PATH}", "{WORK_DIR}", "{JOB_JSON}"]

# (role, overrides, whether the executor's command is checked); "<pki>"
# marks the TLS keys filled from the ``pki`` fixture.
PORTED = {
    "tls": ("gateway", {"<pki>": False}, False),
    "tls crls": ("worker", {"<pki>": True}, False),
    "mux": ("worker", {"network.mux": True}, False),
    "executor cmd": ("worker", {"executor.runtime": "process", "executor.cmd": "<python>",
                                "executor.args": ["-c", "<echo>", *_PLACEHOLDERS]}, True),
    "executor args": ("worker", {"executor.runtime": "process",
                                 "executor.args": ["-c", "<echo>", *_PLACEHOLDERS]}, True),
}


def _spawn(executor_cls, msgs, node, work_root, **kw) -> dict:
    """Run one job through a process executor; the execution's status."""
    import asyncio

    spec = msgs.JobSpec(job_id="j", executor=msgs.Executor(
        kind="aggregate", name="parameter-server", aggregate=msgs.AggregateExecutorConfig(
            updates=msgs.Receive(msgs.Reference.from_peers(["w"], "updates")),
            results=msgs.Send(msgs.Reference.from_peers(["w"], "results")),
            optimizer=msgs.Nesterov(lr=0.7, momentum=0.9), num_workers=1)))

    async def main():
        await node.start()
        try:
            execution = await executor_cls(node=node, work_root=work_root, **kw).execute(
                "j", spec, "sched")
            return await asyncio.wait_for(execution.wait(), 60)
        finally:
            await node.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_node_option_is_wired_like_the_jax_packages(case, pki, tmp_path):
    """Each node-plane option validates in both packages and reaches the
    node as the JAX CLI's does: an mTLS node whose peer id is its
    certificate's key hash (CRL checks on with ``tls.crls``), a
    ``MuxTransport`` over TCP; and the process executor spawns the named
    command with {SOCKET_PATH}, {WORK_DIR} and {JOB_JSON} substituted and
    exported, as the JAX one does."""
    import shutil
    import ssl
    import sys
    import tempfile

    from hypha_tpu import certs as jcerts
    from hypha_tpu import messages as jmsg
    from hypha_tpu.network import MemoryTransport as JMemory
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.worker.process_executor import ProcessExecutor as JProcess
    from hypha_tpu_torch import messages as tmsg
    from hypha_tpu_torch.network import MemoryTransport, MuxTransport, Node, TcpTransport
    from hypha_tpu_torch.worker.process_executor import ProcessExecutor

    role, raw, spawns = PORTED[case]
    out = tmp_path / "echo.json"
    over = {}
    for key, value in raw.items():
        if key == "<pki>":
            over.update(_tls(pki, value))
        elif key == "executor.args":
            over[key] = [_ECHO % str(out) if a == "<echo>" else a for a in value]
        else:
            over[key] = sys.executable if value == "<python>" else value
    # The reference's executor.cmd has no default; the port's names python3.
    jover = {**over, "executor.cmd": over.get("executor.cmd", tnc.TRAINER_CMD)} if spawns else over
    confs = {name: cfg.builder(getattr(nc, SCHEMA[role])).with_overrides(o).build()
             .validate().value
             for name, cfg, nc, o in (("jax", jcfg, jnc, jover), ("port", tcfg, tnc, over))}
    nodes = {"jax": jcli._make_node(confs["jax"], registry_server=role == "gateway"),
             "port": tcli._make_node(confs["port"], registry_server=role == "gateway")}
    assert nodes["port"].peer_id == nodes["jax"].peer_id
    if "tls.cert" in over:
        assert nodes["port"].peer_id == jcerts.peer_id_from_cert_pem((pki / "n1.crt").read_bytes())
        ctx = nodes["port"].transport._server_ssl
        assert ctx.verify_mode == ssl.CERT_REQUIRED
        assert bool(ctx.verify_flags & ssl.VERIFY_CRL_CHECK_LEAF) == ("tls.crls" in over)
        assert nodes["port"]._gossip_key.public_key().spki_der() == \
            nodes["jax"]._gossip_key.public_key().public_bytes(
                jcerts.serialization.Encoding.DER,
                jcerts.serialization.PublicFormat.SubjectPublicKeyInfo)
    want = MuxTransport if over.get("network.mux") else TcpTransport
    assert type(nodes["port"].transport) is want
    assert type(nodes["jax"].transport).__name__ == want.__name__
    if isinstance(nodes["port"].transport, MuxTransport):
        assert type(nodes["port"].transport.base) is TcpTransport
    if not spawns:
        return
    executor = confs["port"].executor
    assert executor.cmd == over.get("executor.cmd", tnc.TRAINER_CMD)
    got = {}
    root = Path(tempfile.mkdtemp(prefix="hx"))  # a short root: the bridge socket lives in it
    try:
        for name, cls, msgs, node, kw in (
                ("jax", JProcess, jmsg, JNode(JMemory(), peer_id="w"), {}),
                ("port", ProcessExecutor, tmsg, Node(MemoryTransport(), peer_id="w"),
                 {"device": torch.device("cpu")})):
            status = _spawn(cls, msgs, node, root / name, cmd=executor.cmd,
                            args=list(executor.args), **kw)
            assert status.state == "completed", (name, status)
            got[name] = json.loads(out.read_text())
            out.unlink()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, echo in got.items():
        socket_path, work_dir, job_json = echo["argv"]
        assert echo["env"]["SOCKET_PATH"] == socket_path and socket_path.endswith("bridge.sock")
        assert echo["env"]["WORK_DIR"] == work_dir == str(Path(socket_path).parent)
        assert echo["env"]["JOB_JSON"] == job_json
    assert got["port"]["argv"][2] == got["jax"]["argv"][2]
    assert got["port"]["env"]["DEVICE"] == "cpu"


# The router, prefix-cache and fleet-cache keys, refused until they were
# ported.
ROUTED = {
    "serve workers": {"job.serve_workers": 2},
    "queue limit": {"job.serve_queue_limit": 4},
    "prefix affinity": {"job.serve_prefix_affinity": True},
    "prefix cache": {"job.serve_prefix_cache": True},
    "routed deployment": {"job.serve_workers": 2, "job.serve_queue_limit": 4,
                          "job.serve_prefix_affinity": True, "job.serve_prefix_cache": True},
    "fleet cache": {"job.serve_workers": 2, "job.serve_prefix_cache": True,
                    "job.serve_fleet_cache": True},
    "kv migration": {"job.serve_workers": 2, "job.serve_prefix_cache": True,
                     "job.serve_kv_migration": True},
    "digest k": {"job.serve_workers": 2, "job.serve_prefix_cache": True,
                 "job.serve_fleet_cache": True, "job.serve_digest_k": 16},
}


@pytest.mark.parametrize("case", sorted(ROUTED))
def test_router_and_prefix_cache_keys_reach_the_supervisor(case):
    """Each key validates and reaches the serving supervisor as the JAX
    CLI hands it over: the same slots, routing, queue limit and affinity,
    and the same dispatched executor config bytes."""
    from hypha_tpu import messages as jmsg
    from hypha_tpu.network import MemoryTransport as JMemory
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.scheduler.serving import ServingSupervisor as JSupervisor
    from hypha_tpu_torch import messages as tmsg
    from hypha_tpu_torch.network import MemoryTransport, Node
    from hypha_tpu_torch.scheduler.serving import ServingSupervisor

    over = {**SERVE, **ROUTED[case], "job.worker_tpu": 0.0}
    sups = {}
    for name, cfg, nc, sup_cls, node in (
            ("jax", jcfg, jnc, JSupervisor, JNode(JMemory().shared(), peer_id="s")),
            ("port", tcfg, tnc, ServingSupervisor, Node(MemoryTransport().shared(),
                                                        peer_id="s"))):
        job = cfg.builder(nc.SchedulerConfig).with_overrides(over).build().validate().value.job
        sups[name] = sup_cls(
            node, job.to_model_spec(), job.serve_name, max_new_tokens=job.serve_max_new_tokens,
            max_batch=job.serve_max_batch, num_workers=job.serve_workers,
            queue_limit=job.serve_queue_limit, pool_block_size=job.serve_block_size,
            pool_prefix_cache=job.serve_prefix_cache, prefix_affinity=job.serve_prefix_affinity,
            fleet_cache=job.serve_fleet_cache, kv_migration=job.serve_kv_migration,
            fleet_digest_k=job.serve_digest_k)
    for key in ("num_workers", "route", "queue_limit", "prefix_affinity"):
        assert getattr(sups["port"], key) == getattr(sups["jax"], key), key
    assert tmsg.encode(sups["port"]._config) == jmsg.encode(sups["jax"]._config)
    want, port = ROUTED[case], sups["port"]
    assert port.num_workers == want.get("job.serve_workers", 1)
    assert port.queue_limit == want.get("job.serve_queue_limit", 0)
    assert port.prefix_affinity == want.get("job.serve_prefix_affinity", False)
    assert port._config.pool_prefix_cache == want.get("job.serve_prefix_cache", False)
    fleet = want.get("job.serve_fleet_cache", False)
    assert port.fleet_cache is fleet and port.kv_migration is want.get(
        "job.serve_kv_migration", False)
    assert port._config.fleet_digest_k == (want.get("job.serve_digest_k", 32) if fleet else None)


@pytest.mark.parametrize("over", [
    {"job.sync_mode": "overlap"},
    {"job.delta_codec": "int8"},
    {"job.sync_mode": "stream", "job.num_fragments": 4, "job.delta_codec": "int4"},
], ids=["sync mode", "delta codec", "stream"])
def test_stream_and_codec_keys_reach_the_job(over):
    """The TOML's ``job.delta_codec``, ``job.sync_mode`` and
    ``job.num_fragments`` build the same DiLoCoJob bytes in both packages."""
    over = {**over, "job.dataset": "counting", "job.worker_tpu": 0.0}
    jbuilt = jcfg.builder(jnc.SchedulerConfig).with_overrides(over).build()
    tbuilt = tcfg.builder(tnc.SchedulerConfig).with_overrides(over).build()
    jbuilt.validate()
    tbuilt.validate()
    jjob, tjob = jbuilt.value.job.to_job(), tbuilt.value.job.to_job()
    for key in ("delta_codec", "sync_mode", "num_fragments"):
        assert getattr(tjob, key) == getattr(jjob, key) == over.get(
            f"job.{key}", {"delta_codec": "none", "sync_mode": "blocking", "num_fragments": 0}[key])


def test_defaults_are_accepted_and_the_cli_exits_2_on_an_unported_option(capsys):
    for role in ("gateway", "worker", "scheduler"):
        tcfg.builder(getattr(tnc, SCHEMA[role])).build().validate()
    code = tcli.main(["scheduler", "run", "--set", "job.sharding={tp = 2}"])
    assert code == 2
    assert "Queue 1: intra-replica sharding" in capsys.readouterr().err
    assert tcli.main(["gateway", "run", "--set", "offer.price=1"]) == 2
    assert "unknown config key" in capsys.readouterr().err


@pytest.mark.parametrize("role", ["gateway", "worker", "scheduler"])
def test_the_trace_switch_in_the_environment_is_no_config_key(role, monkeypatch, tmp_path):
    """``HYPHA_TRACE_DIR`` / ``HYPHA_TRACE_NODE`` turn a process's tracing
    on: the port's env layer passes over them, so a CLI node can trace
    through its environment, and builds the section the JAX package builds
    without them (the reference's builder refuses them as unknown keys)."""
    over = {"job.worker_tpu": 0.0} if role == "scheduler" else {}
    want = tcfg.builder(getattr(tnc, SCHEMA[role])).with_env("HYPHA_").with_overrides(
        over).build().validate().value
    monkeypatch.setenv("HYPHA_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("HYPHA_TRACE_NODE", "w0")
    got = tcfg.builder(getattr(tnc, SCHEMA[role])).with_env("HYPHA_").with_overrides(
        over).build().validate().value
    assert got == want
    with pytest.raises(jcfg.ConfigError, match="trace_dir"):
        jcfg.builder(getattr(jnc, SCHEMA[role])).with_env("HYPHA_").with_overrides(
            over).build().validate()
