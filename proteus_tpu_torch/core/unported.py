"""Paths of ``proteus_tpu`` that the port does not run yet.

Each raises ``NotImplementedError`` naming its ``ROADMAP.md`` item, so that
no unported path ever runs silently as something else.
"""

COVER_MODE = ("mask_adjacent_to_cloud_mode 'cover'"
              ' (ROADMAP.md Queue 1 item 9, kernel slice K2)')
SCALED_DIAGNOSTICS = ('float (offset-and-scaled) inputs and thresholds that'
                      ' are not exact rationals (ROADMAP.md Queue 1 item 10,'
                      ' kernel slices K3/K4)')
OCEAN_MASK = 'apply_ocean_masking (ROADMAP.md Queue 1 item 11)'
OTSU_SHADOW = "shadow_masking_algorithm 'otsu' (ROADMAP.md Queue 1 item 12)"
RAW_S2_RESAMPLE = ('10 m / 20 m Sentinel-2 band ingest'
                   ' (ROADMAP.md Queue 1 item 13)')


def not_ported(what):
    return NotImplementedError(f'not ported to proteus_tpu_torch yet: {what}')
