"""Elastic / fault-tolerant training (``hvd.elastic``).

Reference analogs (SURVEY.md §3.5): horovod/common/elastic.py (run_fn),
horovod/torch/elastic/ (state, sampler); own copy of
``horovod_tpu/elastic/__init__.py``.  The retry loop: wrap the training
function; on a failed collective (:class:`HorovodInternalError`) restore the
last committed state, re-rendezvous, and re-run; on a driver-announced host
change (:class:`HostsUpdatedInterrupt`) keep the current state and
re-rendezvous.  A worker's exit reaches the elastic driver, which re-forms
the job from the survivors and respawns the lost slots.
"""

from __future__ import annotations

import functools

from ..exceptions import HorovodInternalError, HostsUpdatedInterrupt
# The reference's elastic namespace re-exports the broadcast helpers.
from ..functions import (broadcast_object,  # noqa: F401
                         broadcast_optimizer_state, broadcast_parameters)
from ..utils.logging import get_logger
from .state import (ElasticSampler, ObjectState, State,  # noqa: F401
                    TorchState)
from . import client as _client
from . import migrate  # noqa: F401  (re-export: hvd.elastic.migrate)

log = get_logger()


def run(func):
    """Decorator for the elastic training loop:

        @hvd.elastic.run
        def train(state, ...):
            ...

        state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)
        train(state)
    """

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        notification_manager = _client.notification_manager
        reset_required = False
        while True:
            if reset_required:
                _reset(state)
                reset_required = False
            # Migration-aware sync: resume from in-memory peer shards when
            # they cover the re-formation, checkpoint/broadcast otherwise.
            migrate.sync_state(state)
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError as exc:
                msg = str(exc)
                if "culprit rank" in msg:
                    # Fast-abort attribution (socket_controller.cc ABORT
                    # broadcast): the coordinator named the failed peer.
                    log.warning("elastic: aborted by a peer failure — %s; "
                                "restoring last committed state", msg)
                else:
                    log.warning("elastic: collective failed (%s); restoring "
                                "last committed state", exc)
                if not _client.is_elastic_worker():
                    raise
                state.restore()
                reset_required = True
            except HostsUpdatedInterrupt:
                log.info("elastic: host set updated; re-rendezvousing")
                if not _client.is_elastic_worker():
                    raise
                # Keep current (uncommitted) progress: the world changed but
                # this worker's state is intact.
                reset_required = True
            finally:
                # Swallow any update that raced with a failure we already
                # handled, so the next round starts clean.
                notification_manager.drain_updates()

    return wrapper


def _reset(state: State) -> None:
    """Tear down collectives, wait for the next generation's assignment,
    re-initialize (on the device of this process's first ``init``), and
    notify user callbacks."""
    from .. import basics
    from ..process_sets import reregister_all

    if basics.is_initialized():
        basics.shutdown()
    client = _client.get_client()
    client.mark_ready()
    client.wait_assignment()
    basics.init()
    # Replay user process-set registrations against the new world: a shrink
    # drops departed ranks from each set's live membership, a re-grow
    # re-admits them (ProcessSet.desired_ranks keeps the original request).
    reregister_all()
    migrate.on_reset()
    state.on_reset()
