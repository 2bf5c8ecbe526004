"""Paths of ``proteus_tpu`` that the port does not run yet.

Each raises ``NotImplementedError`` naming its ``ROADMAP.md`` item, so that
no unported path ever runs silently as something else.
"""

INEXACT_THRESHOLDS = ('integer-band thresholds that are not exact rationals'
                      ' (ROADMAP.md Queue 1 item 17)')
MULTI_HOST = ('multi-host campaign dispatch, --hosts > 1'
              ' (ROADMAP.md Queue 1 item 20)')


def not_ported(what):
    return NotImplementedError(f'not ported to proteus_tpu_torch yet: {what}')
