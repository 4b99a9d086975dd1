# tpulint fixture: exception hygiene (TPU301).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
import logging

logger = logging.getLogger(__name__)


def swallow():
    try:
        risky()
    except Exception:  # TPU301 @ line 11
        pass


def swallow_bare():
    try:
        risky()
    except:  # noqa: E722  TPU301 @ line 18
        return None


def ok_logs():
    try:
        risky()
    except Exception:
        logger.warning("risky failed", exc_info=True)


def ok_reraises():
    try:
        risky()
    except Exception:
        cleanup()
        raise


def ok_pragma():
    try:
        risky()
    # tpulint: allow(broad-except reason=fixture demonstrating a deliberate swallow)
    except Exception:
        pass


def reasonless_pragma():
    try:
        risky()
    # tpulint: allow(broad-except)
    except Exception:  # TPU301 @ line 49 (pragma without reason= is inert)
        pass


def ok_typed():
    try:
        risky()
    except ValueError:
        return None


def risky():
    raise ValueError


def cleanup():
    pass
