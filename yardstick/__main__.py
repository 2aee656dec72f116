import sys

from yardstick.run import main

sys.exit(main())
