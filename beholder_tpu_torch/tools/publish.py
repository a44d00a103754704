"""Telemetry producer CLI (the port's own copy of the reference's
``tools/publish.py``).

The reference ecosystem's producers (the triton converter/downloader
services) publish ``api.TelemetryStatus`` / ``api.TelemetryProgress``
protos to RabbitMQ; beholder only consumes them. This tool is the
operator-side counterpart for smoke tests and backfills:

    python -m beholder_tpu_torch.tools.publish status --media-id m1 --status DEPLOYED
    python -m beholder_tpu_torch.tools.publish progress --media-id m1 \
        --status CONVERTING --progress 55 --host enc-1
    python -m beholder_tpu_torch.tools.publish status ... --url amqp://user:pw@host:5672/

``--url`` defaults to ``dyn('rabbitmq')`` resolution, same as the service.
"""

from __future__ import annotations

import argparse
import sys

from beholder_tpu_torch import proto
from beholder_tpu_torch.config import dyn
from beholder_tpu_torch.mq.amqp import AmqpBroker
from beholder_tpu_torch.service import PROGRESS_TOPIC, STATUS_TOPIC

STATUS_NAMES = list(proto.TelemetryStatusEntry.keys())


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="beholder-publish", description=__doc__.split("\n\n")[0]
    )
    parser.add_argument("--url", default=None, help="amqp:// broker URL")
    parser.add_argument(
        "--trace",
        action="store_true",
        help="start a trace: send an uber-trace-id header so the consumer's "
        "span joins this publish's trace",
    )
    sub = parser.add_subparsers(dest="kind", required=True)

    status = sub.add_parser("status", help="publish a status transition")
    progress = sub.add_parser("progress", help="publish a progress update")
    for p in (status, progress):
        p.add_argument("--media-id", required=True)
        p.add_argument("--status", required=True, choices=STATUS_NAMES)
        # accepted after the subcommand too; SUPPRESS keeps a post-subcommand
        # default from clobbering a pre-subcommand value
        p.add_argument("--url", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    progress.add_argument("--progress", type=int, required=True, metavar="PCT")
    progress.add_argument("--host", default="")
    return parser


def encode_message(args: argparse.Namespace) -> tuple[str, bytes]:
    status = proto.TelemetryStatusEntry.Value(args.status)
    if args.kind == "status":
        return STATUS_TOPIC, proto.encode(
            proto.TelemetryStatus(mediaId=args.media_id, status=status)
        )
    if not 0 <= args.progress <= 100:
        raise SystemExit(f"--progress must be 0..100, got {args.progress}")
    return PROGRESS_TOPIC, proto.encode(
        proto.TelemetryProgress(
            mediaId=args.media_id,
            status=status,
            progress=args.progress,
            host=args.host,
        )
    )


def main(argv: list[str] | None = None, broker: AmqpBroker | None = None) -> int:
    args = build_parser().parse_args(argv)
    topic, body = encode_message(args)

    headers = None
    span = None
    if getattr(args, "trace", False):
        from beholder_tpu_torch.log import get_logger
        from beholder_tpu_torch.tracing import LogReporter, Tracer, inject

        tracer = Tracer("beholder-publish", reporter=LogReporter(get_logger("trace")))
        span = tracer.start_span(
            "publish", tags={"topic": topic, "mediaId": args.media_id}
        )
        headers = inject(span.context, {})

    own_broker = broker is None
    if own_broker:
        broker = AmqpBroker(args.url or dyn("rabbitmq"))
        broker.connect(timeout=10)
    try:
        broker.publish(topic, body, headers=headers)
    finally:
        if span is not None:
            span.finish()
        if own_broker:
            broker.close()
    print(f"published {args.kind} for {args.media_id} to {topic}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
