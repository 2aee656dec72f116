"""One driver a kind of traffic; a traffic file names its driver, and every
parameter the driver reads is in that file or in the configuration's."""

from yardstick.drivers.extract import ExtractCell
from yardstick.drivers.train import TrainCell

DRIVERS = {"train": TrainCell, "extract": ExtractCell}
