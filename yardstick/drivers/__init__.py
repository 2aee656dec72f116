"""One driver a kind of traffic: ``drivers/<driver>.py``, found by the
``"driver"`` of a traffic file (``spec.Cell.driver``), exports ``CELL``, the
class that runs a cell of that traffic; what it needs of the model it asks
the configuration's model file (``models/``). Every parameter a driver
reads is in the traffic's file or the configuration's."""
