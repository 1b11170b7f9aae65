"""The node CLI: ``python -m hypha_tpu_torch {gateway|scheduler|worker|data}
{init|probe|run}`` (counterpart of ``hypha_tpu/cli.py``).

Reference: every binary exposes the same three subcommands
(e.g. crates/scheduler/src/bin/hypha-scheduler.rs:459-548) —

  * ``init``  — emit a documented default config TOML
                (crates/data/src/bin/hypha-data.rs:239-272);
  * ``probe`` — dial an address and run the health protocol
                (hypha-scheduler.rs:494-535);
  * ``run``   — layered config (TOML ← HYPHA_* env ← CLI) → validate →
                role runtime → serve until SIGINT/SIGTERM → ordered
                shutdown (§3.3 bootstrap skeleton).

A node is mTLS-secured when its ``[tls]`` section names cert, key and
trust (its peer id is then its certificate's key hash, and it signs its
gossip), and multiplexes its streams over one connection a peer when
``network.mux`` is set; the telemetry exporter is refused when set
(``node_config.py``). Each runner logs its fabric's counts when it stops
(``fabric counts: {...}``: connections dialed and accepted, mux streams,
gossip frames signed, verified and dropped, the median verify ms).
``worker run`` runs on CUDA unless given ``--device cpu``; without CUDA
and without the flag it exits with ``default_device``'s error before it
starts.
``scheduler run`` runs a DiLoCo job through the port's ``Orchestrator``
(``job.kind = "train"``) or keeps one serving deployment alive through
``ServingSupervisor`` until SIGINT/SIGTERM (``job.kind = "serve"``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import statistics
import sys
import tomllib
from pathlib import Path

from . import aio
from . import config as cfg
from .node_config import DataNodeConfig, GatewayConfig, SchedulerConfig, WorkerConfig

__all__ = ["main", "build_parser"]

log = logging.getLogger("hypha.torch.cli")

_SCHEMAS = {
    "gateway": GatewayConfig,
    "scheduler": SchedulerConfig,
    "worker": WorkerConfig,
    "data": DataNodeConfig,
}


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------


def _load_config(role: str, args) -> object:
    builder = cfg.builder(_SCHEMAS[role])
    if args.config:
        builder.with_toml(args.config)
    builder.with_env("HYPHA_")
    overrides = {}
    for item in args.set or []:
        key, sep, value = item.partition("=")
        if not sep:
            raise cfg.ConfigError(f"--set needs key=value, got {item!r}")
        overrides[key.strip()] = _parse_cli_value(value.strip())
    if args.name:
        overrides["name"] = args.name
    built = builder.with_overrides(overrides, "cli").build().validate()
    return built.value


def _parse_cli_value(raw: str):
    """``--set`` values are strings; interpret them as TOML values so ints,
    floats, bools and arrays come through typed. Bare strings stay strings."""
    try:
        return tomllib.loads(f"v = {raw}")["v"]
    except tomllib.TOMLDecodeError:
        return raw


def _node_kwargs(conf, *, registry_server: bool = False) -> dict:
    return dict(
        bootstrap=list(conf.network.gateways),
        registry_server=registry_server,
        exclude_cidrs=list(conf.network.exclude_cidrs),
        # Non-gateway nodes hold circuit reservations at their gateways so
        # NAT'd peers stay reachable (reference listens on relay circuits by
        # default, crates/network/src/listen.rs:25-131).
        relay_listen=not registry_server and conf.network.relay,
        advertise_listen=conf.network.advertise_listen,
    )


def _make_node(conf, *, registry_server: bool = False, peer_id: "str | None" = None):
    """Transport from the TLS section: mTLS when configured, plain TCP
    otherwise (dev mode); muxed when ``network.mux`` is set."""
    kwargs = _node_kwargs(conf, registry_server=registry_server)
    if conf.tls.enabled():
        from .network.secure import secure_node

        node = secure_node(conf.tls.cert, conf.tls.key, conf.tls.trust,
                           conf.tls.crls or None, **kwargs)
    else:
        from .network.fabric import TcpTransport
        from .network.node import Node

        node = Node(TcpTransport(), peer_id=peer_id or conf.name, **kwargs)
    if conf.network.mux:
        from .network.mux import MuxTransport

        node.transport = MuxTransport(node.transport)
    node.external_addrs = list(conf.network.external)
    return node


def _log_fabric_counts(node) -> None:
    """Log what the node's fabric did (read by operators and the smoke)."""
    counts, transport = {}, node.transport
    while transport is not None:  # a MuxTransport wraps its base
        counts.update(getattr(transport, "counts", {}))
        transport = getattr(transport, "base", None)
    verify = list(node.gossip_verify_s)
    log.info("fabric counts: %s", json.dumps({
        **counts, "gossip": node.gossip_counts,
        "verify_ms_median": statistics.median(verify) * 1e3 if verify else None}))


def _signal_event(stop: "asyncio.Event | None") -> asyncio.Event:
    """``stop``, or an event SIGINT/SIGTERM sets; a caller that runs
    several roles in one process (the tests) passes ``stop`` and keeps its
    signals."""
    if stop is None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
    return stop


async def _serve_until_signal(stop: "asyncio.Event | None" = None) -> None:
    """Wait for SIGINT/SIGTERM (or ``stop``)."""
    await _signal_event(stop).wait()
    log.info("shutting down")


def _cmd_init(role: str, args) -> int:
    schema = _SCHEMAS[role]()
    if args.name:
        schema.name = args.name
    text = cfg.to_toml(schema)
    out = Path(args.output or f"{role}.toml")
    out.write_text(text)
    print(f"wrote {out}")
    return 0


def _cmd_probe(role: str, args) -> int:
    async def main() -> bool:
        from .health import probe
        from .network.fabric import TcpTransport
        from .network.node import Node

        if args.config:
            conf = _load_config(role, args)
            node = _make_node(conf, peer_id=f"probe-{conf.name}")
        else:
            node = Node(TcpTransport(), peer_id="probe")
        await node.start(["127.0.0.1:0"])
        try:
            return await probe(node, args.addr, timeout=args.timeout)
        finally:
            await node.stop()

    healthy = asyncio.run(main())
    print("healthy" if healthy else "unhealthy")
    return 0 if healthy else 1


# --------------------------------------------------------------------------
# run per role
# --------------------------------------------------------------------------


async def _run_gateway(conf: GatewayConfig, *, stop: "asyncio.Event | None" = None) -> None:
    from .gateway import Gateway

    gw = Gateway(None, node=_make_node(conf, registry_server=True))
    await gw.start(list(conf.network.listen))
    try:
        print(f"gateway {gw.peer_id} on {gw.node.listen_addrs}", flush=True)
        await _serve_until_signal(stop)
    finally:
        _log_fabric_counts(gw.node)
        await gw.stop()


async def _run_data(conf: DataNodeConfig, *, stop: "asyncio.Event | None" = None) -> None:
    from .data_node import DataNode

    dn = DataNode(None, {name: Path(p) for name, p in conf.datasets.items()},
                  node=_make_node(conf))
    await dn.start(list(conf.network.listen))
    try:
        print(f"data node {dn.peer_id} on {dn.node.listen_addrs}", flush=True)
        await _serve_until_signal(stop)
    finally:
        _log_fabric_counts(dn.node)
        await dn.stop()


async def _run_worker(conf: WorkerConfig, *, device=None,
                      stop: "asyncio.Event | None" = None) -> None:
    from .worker.arbiter import OfferConfig
    from .worker.runtime import WorkerNode

    worker = WorkerNode(
        None,
        resources=conf.resources.to_resources(),
        device=device,
        offer=OfferConfig(
            price=conf.offer.price, floor=conf.offer.floor, strategy=conf.offer.strategy
        ),
        train_runtime=conf.executor.runtime,
        train_cmd=conf.executor.cmd or None,
        train_args=list(conf.executor.args) or None,
        work_root=conf.work_root,
        node=_make_node(conf),
    )
    stop = _signal_event(stop)
    starting = asyncio.create_task(worker.start(list(conf.network.listen)))
    stopping = asyncio.create_task(stop.wait())
    try:
        # A signal may come while the worker waits for its gateways (one
        # that refuses this node's certificate never answers): stop then.
        await asyncio.wait({starting, stopping}, return_when=asyncio.FIRST_COMPLETED)
        if not starting.done():
            log.info("stopped before the bootstrap completed")
            return
        starting.result()
        print(f"worker {worker.peer_id} on {worker.node.listen_addrs} ({worker.device})",
              flush=True)
        await _serve_until_signal(stop)
    finally:
        await aio.reap(starting, stopping)
        _log_fabric_counts(worker.node)
        await worker.stop()


async def _run_scheduler(conf: SchedulerConfig, *, stop: "asyncio.Event | None" = None):
    """Serve kind: until SIGINT/SIGTERM (or ``stop``). Train kind: until the
    job ends; returns its ``JobResult``."""
    from .scheduler.metrics_bridge import AimConnector, NoOpConnector
    from .scheduler.orchestrator import Orchestrator

    node = _make_node(conf)
    await node.start(list(conf.network.listen))
    print(f"scheduler {node.peer_id} on {node.listen_addrs}", flush=True)
    try:
        await node.wait_for_bootstrap()
        if conf.job.kind == "serve":
            await _serve_job(node, conf, stop)
            return None
        connector = (
            AimConnector(conf.status_bridge) if conf.status_bridge else NoOpConnector()
        )
        orch = Orchestrator(node, metrics_connector=connector)
        result = await orch.run(conf.job.to_job(), max_attempts=conf.job.max_attempts)
        print(f"job {result.job_id} completed: {result.rounds} rounds", flush=True)
        if result.ft is not None:
            print(f"job {result.job_id} membership: {json.dumps(result.ft)}", flush=True)
        return result
    finally:
        _log_fabric_counts(node)
        await node.stop()


async def _serve_job(node, conf: SchedulerConfig, stop: "asyncio.Event | None") -> None:
    """Auction a worker, dispatch the serving job and hold it until a
    signal; then stop the supervisor, which cancels the job on the worker
    and releases its lease."""
    from .scheduler.serving import ServingSupervisor

    job = conf.job
    sup = ServingSupervisor(
        node,
        job.to_model_spec(),
        job.serve_name,
        resources=job.worker_resources(),
        price=job.worker_price(),
        max_new_tokens=job.serve_max_new_tokens,
        max_batch=job.serve_max_batch,
        num_workers=job.serve_workers,
        queue_limit=job.serve_queue_limit,
        pool_block_size=job.serve_block_size,
        pool_blocks=job.serve_blocks,
        pool_prefill_chunk=job.serve_prefill_chunk,
        pool_prefix_cache=job.serve_prefix_cache,
        pool_spec_ngram=job.serve_spec_ngram,
        pool_spec_draft=job.serve_spec_draft,
        pool_ragged=job.serve_ragged,
        pool_kv_quant=job.serve_kv_quant,
        pool_spec_layers=job.serve_spec_layers,
        fleet_cache=job.serve_fleet_cache,
        kv_migration=job.serve_kv_migration,
        fleet_digest_k=job.serve_digest_k,
        prefix_affinity=job.serve_prefix_affinity,
        eos_token_id=None if job.serve_eos_token_id < 0 else job.serve_eos_token_id,
    )
    print(f"serving {job.serve_name!r} x{job.serve_workers}; ctrl-c to stop", flush=True)
    runner = asyncio.create_task(sup.run())
    # Watch the supervisor too: if it dies, surface the error now instead
    # of sitting signal-parked while serving nothing.
    signal_task = asyncio.create_task(_serve_until_signal(stop))
    try:
        await asyncio.wait({signal_task, runner}, return_when=asyncio.FIRST_COMPLETED)
    finally:
        signal_task.cancel()
        await sup.stop()
        await runner


def _cmd_run(role: str, args) -> int:
    conf = _load_config(role, args)
    kw = {}
    if role == "worker":
        from .hw import default_device

        try:  # before anything starts: no quiet run on the host
            kw["device"] = default_device(args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    try:
        asyncio.run(_RUNNERS[role](conf, **kw))
    except KeyboardInterrupt:
        pass
    return 0


_RUNNERS = {
    "gateway": _run_gateway,
    "scheduler": _run_scheduler,
    "worker": _run_worker,
    "data": _run_data,
}


# --------------------------------------------------------------------------
# argument parsing
# --------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m hypha_tpu_torch",
        description="decentralized DiLoCo training and serving on PyTorch/CUDA",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    roles = parser.add_subparsers(dest="role", required=True)
    for role in _SCHEMAS:
        rp = roles.add_parser(role, help=f"{role} node")
        cmds = rp.add_subparsers(dest="cmd", required=True)

        p_init = cmds.add_parser("init", help="write a documented default config")
        p_init.add_argument("-o", "--output", help=f"path (default {role}.toml)")
        p_init.add_argument("--name", help="node name")

        p_probe = cmds.add_parser("probe", help="health-check a running node")
        p_probe.add_argument("addr", help="host:port to probe")
        p_probe.add_argument("-c", "--config", help="config TOML")
        p_probe.add_argument("--timeout", type=float, default=10.0)
        p_probe.add_argument("--set", action="append", metavar="KEY=VALUE")
        p_probe.add_argument("--name")

        p_run = cmds.add_parser("run", help="run the node")
        p_run.add_argument("-c", "--config", help="config TOML")
        p_run.add_argument(
            "--set", action="append", metavar="KEY=VALUE",
            help="override a config key (dotted paths ok)",
        )
        p_run.add_argument("--name", help="override node name")
        if role == "worker":
            p_run.add_argument(
                "--device", default=None,
                help="torch device (default: cuda; without a CUDA device the worker "
                "exits unless given --device cpu)",
            )
    return parser


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    try:
        if args.cmd == "init":
            return _cmd_init(args.role, args)
        if args.cmd == "probe":
            return _cmd_probe(args.role, args)
        return _cmd_run(args.role, args)
    except cfg.ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    except NotImplementedError as e:
        print(f"not ported: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
