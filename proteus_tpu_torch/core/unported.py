"""Paths of ``proteus_tpu`` that the port does not run yet.

Each raises ``NotImplementedError`` naming its ``ROADMAP.md`` item, so that
no unported path ever runs silently as something else.
"""

INEXACT_THRESHOLDS = ('integer-band thresholds that are not exact rationals'
                      ' (ROADMAP.md Queue 1 item 17)')
OTSU_SHADOW = "shadow_masking_algorithm 'otsu' (ROADMAP.md Queue 1 item 12)"
RAW_S2_RESAMPLE = ('10 m / 20 m Sentinel-2 band ingest'
                   ' (ROADMAP.md Queue 1 item 13)')
MULTI_HOST = ('multi-host campaign dispatch, --hosts > 1'
              ' (ROADMAP.md Queue 1 item 20)')


def not_ported(what):
    return NotImplementedError(f'not ported to proteus_tpu_torch yet: {what}')
