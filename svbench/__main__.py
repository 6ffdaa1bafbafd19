import sys

from svbench.run import main

sys.exit(main())
