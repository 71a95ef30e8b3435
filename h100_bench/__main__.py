import sys

from h100_bench.run import main

sys.exit(main())
