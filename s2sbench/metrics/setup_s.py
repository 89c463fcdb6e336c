"""Set-up: the process's start to the serve's readiness: weights made on
the card, the port's quantization, the engines' warm-up, the kernel
library's load (its build on a checkout's first run), the server
listening.  The sessions' first turns, which run before the window opens,
are outside it, so a turn's time under load does not count as set-up."""


def read(run):
    return run.setup_s
