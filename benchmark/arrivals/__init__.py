"""How a cell's calls arrive, one module each: a traffic file's
``"arrival"`` names ``benchmark/arrivals/<arrival>.py``, whose
``drive(call, seconds, traffic)`` makes the calls of the measured window
and returns what end-to-end readers read of it (at least ``calls`` and
``window_s``)."""
