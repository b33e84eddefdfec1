"""Each kernel's operations and bytes at the shapes it is called with, and
the chip's peaks (`peaks.py`): the least time the chip could take for a
call, the larger of its bytes over the memory's bandwidth and its
operations over the type's peak.  Each input byte counts once and each
output byte once, whatever the kernel reads again; where the work depends
on the data, the count is what these inputs need."""
