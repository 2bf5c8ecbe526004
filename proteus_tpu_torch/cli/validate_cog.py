"""validate_cog: structural cloud-optimized GeoTIFF validation CLI.

Equivalent of the reference's extern/validate_cloud_optimized_geotiff.py
command-line usage; exits 0 when valid. The port's copy of
``proteus_tpu/cli/validate_cog.py``:

    python -m proteus_tpu_torch.cli.validate_cog FILE [FILE ...]
        [--full-check yes|no]
"""

import argparse
import sys

from proteus_tpu_torch.io.validate_cog import validate_cog


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Validate cloud-optimized GeoTIFF structure')
    parser.add_argument('filename', nargs='+')
    parser.add_argument('--full-check', dest='full_check', default='yes',
                        choices=['yes', 'no'])
    args = parser.parse_args(argv)
    ret = 0
    for f in args.filename:
        errors = validate_cog(f, full_check=args.full_check == 'yes')
        if errors:
            ret = 1
            print(f'{f} is NOT a valid cloud optimized GeoTIFF:')
            for e in errors:
                print(f'  - {e}')
        else:
            print(f'{f} is a valid cloud optimized GeoTIFF')
    return ret


if __name__ == '__main__':
    sys.exit(main())
