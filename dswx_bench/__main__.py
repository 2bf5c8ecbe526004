import sys

from dswx_bench.run import main

sys.exit(main())
