import os
import re

from setuptools import setup, find_packages


def get_version():
    here = os.path.dirname(__file__)
    with open(os.path.join(here, 'proteus_tpu', 'version.py')) as fh:
        text = fh.read()
    m = re.search(r"VERSION\s*=\s*['\"]([\d.]+)['\"]", text)
    if m is None:
        raise ValueError('malformed proteus_tpu/version.py')
    return m.group(1)


setup(
    name='proteus_tpu',
    version=get_version(),
    description='TPU-native Dynamic Surface Water Extent (DSWx-HLS) '
                'framework: JAX/XLA/Pallas science core with a '
                'self-contained GeoTIFF/COG + geodesy runtime',
    packages=find_packages(include=['proteus_tpu', 'proteus_tpu.*',
                                    'proteus_tpu_torch',
                                    'proteus_tpu_torch.*']),
    package_data={'proteus_tpu.config': ['defaults/*.yaml',
                                         'schemas/*.yaml'],
                  'proteus_tpu_torch.config': ['defaults/*.yaml',
                                               'schemas/*.yaml'],
                  'proteus_tpu_torch.native': ['tiffturbo.cpp'],
                  'proteus_tpu_torch.ops': ['csrc/*.cu']},
    python_requires='>=3.9',
    install_requires=['numpy', 'scipy', 'jax', 'pyyaml', 'pillow'],
    entry_points={
        'console_scripts': [
            'dswx_hls=proteus_tpu.cli.dswx_hls:main',
            'dswx_compare=proteus_tpu.cli.dswx_compare:main',
            'dswx_campaign=proteus_tpu.cli.dswx_campaign:main',
            'dswx_hls_torch=proteus_tpu_torch.cli.dswx_hls:main',
            'dswx_compare_torch=proteus_tpu_torch.cli.dswx_compare:main',
            'dswx_campaign_torch=proteus_tpu_torch.cli.dswx_campaign:main',
        ],
    },
    scripts=['bin/dswx_hls.py', 'bin/dswx_compare.py'],
    url='https://github.com/opera-adt/PROTEUS',
    license='Apache-2.0',
)
