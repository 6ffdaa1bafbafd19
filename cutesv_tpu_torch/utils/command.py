"""Shell / cluster-submission command runner (reference C13 parity).

The reference ships ``CommandRunner.py`` (reference ``src/cuteSV/
CommandRunner.py:17-151``): a shell ``exe()`` with a minutes-granularity
timeout, plus ``Command``/``CommandRunner`` templating that either runs
commands locally or chunks them into executable scripts and submits each
through a cluster template like ``qsub ... ${CMD}``. The pipeline itself
only ever uses ``exe`` (for temp-dir cleanup, reference ``cuteSV:1247``);
the rest is offered for users' batch workflows, so we provide the same
surface here.

Fresh implementation, same observable behavior:

* ``exe(cmd, timeout)``: run through the shell in its own process group,
  capture interleaved stdout+stderr, return ``(retcode, stdout, stderr)``;
  on timeout kill the group and return ``(214, None, None)`` (reference
  ``CommandRunner.py:17-40``, including the 214 sentinel). We use
  ``subprocess`` timeouts instead of SIGALRM — the reference's alarm
  handler breaks inside worker processes/threads where signals don't
  deliver; behavior at the API is identical.
* ``CommandRunner(template, njobs)``: default template runs locally
  (``${CMD} > ${STDOUT} 2> ${STDERR}``); with ``njobs > 0`` commands are
  round-robin partitioned into ``njobs`` ``<id>_chunk<k>.sh`` scripts
  (made user-executable) and each chunk submitted via the template
  (reference ``CommandRunner.py:75-118``).
* ``partition(items, m)``: round-robin split, empties dropped
  (reference ``CommandRunner.py:139-151`` — returns a list here; the
  reference's py2 ``map``/``filter`` idiom crashes on py3).
* ``CommandRunner.check_template`` validates the template against the
  four known keys (the reference's ``checkTemplate`` references an
  undefined variable and cannot run; ours performs the documented check).
"""
from __future__ import annotations

import logging
import os
import signal
import stat
import subprocess
import sys
import tempfile
from string import Template
from typing import List, Optional, Sequence, Tuple, Union


def setup_logging(debug: bool = False) -> None:
    """stderr logging banner (reference CommandRunner.py:11-15)."""
    level = logging.DEBUG if debug else logging.INFO
    logging.basicConfig(stream=sys.stderr, level=level,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    logging.info("Running %s" % " ".join(sys.argv))


def exe(cmd: str, timeout: float = -1) -> Tuple[int, Optional[bytes],
                                                Optional[bytes]]:
    """Run ``cmd`` through the shell; ``timeout`` is in MINUTES, -1 = never.

    Returns ``(retcode, stdout, stderr)`` with stderr folded into stdout
    (the reference pipes stderr to STDOUT, so its third element is the
    inherited-and-unused pipe read: ``b""``/None in practice); on timeout
    the whole process group is terminated and ``(214, None, None)`` is
    returned (reference CommandRunner.py:17-40).
    """
    proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, close_fds=True,
                            preexec_fn=os.setsid)
    try:
        stdout, stderr = proc.communicate(
            timeout=timeout * 60 if timeout > 0 else None)
    except subprocess.TimeoutExpired:
        logging.error("Command was taking too long. "
                      "Automatic Timeout Initiated after %d" % timeout)
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        proc.kill()
        proc.communicate()
        return 214, None, None
    return proc.returncode, stdout, stderr


class Command:
    """One templated job (reference CommandRunner.py:42-52)."""

    def __init__(self, cmd: str, jobname: str, stdout: str, stderr: str):
        self.cmd = cmd
        self.jobname = jobname
        self.stdout = stdout
        self.stderr = stderr

    def as_dict(self) -> dict:
        return {"CMD": self.cmd, "JOBNAME": self.jobname,
                "STDOUT": self.stdout, "STDERR": self.stderr}

    # reference spelling
    asDict = as_dict


def partition(items: Sequence, m: int) -> List[list]:
    """Round-robin split of ``items`` into ``m`` lists, empties dropped
    (reference CommandRunner.py:139-151)."""
    parts: List[list] = [[] for _ in range(m)]
    index = 0
    for item in items:
        parts[index].append(item)
        index = index + 1 if index < m - 1 else 0
    return [p for p in parts if p]


class CommandRunner:
    """Run or cluster-submit templated commands
    (reference CommandRunner.py:54-137)."""

    KEYS = ("CMD", "JOBNAME", "STDOUT", "STDERR")

    def __init__(self, template: Optional[str] = None, njobs: int = 0):
        if template is None:
            template = "${CMD} > ${STDOUT} 2> ${STDERR}"
            self.run_type = "Running"
        else:
            self.run_type = "Submitting"
        self.template = Template(template)
        self.njobs = njobs

    def build_command(self, command: Command) -> str:
        return self.template.substitute(command.as_dict())

    def check_template(self) -> bool:
        """True iff the template only references the four known keys."""
        try:
            self.template.substitute({k: k.lower() for k in self.KEYS})
        except (KeyError, ValueError):
            logging.error("Your submission template is invalid ")
            return False
        return True

    def __call__(self, cmds: Union[Command, List[Command]],
                 w_dir: Optional[str] = None, id: Optional[str] = None):
        """Run one Command, a list (njobs == 0: sequentially), or chunk a
        list into njobs scripts under ``w_dir`` and submit each."""
        if w_dir is None:
            w_dir = "./"
        if not isinstance(cmds, list):
            return exe(self.build_command(cmds))
        if self.njobs == 0:
            return [exe(self.build_command(c)) for c in cmds]
        if id is None:
            fd, id = tempfile.mkstemp(dir=w_dir)
            os.close(fd)
        results = []
        for chunk, commands in enumerate(partition(cmds, self.njobs)):
            script = os.path.join(w_dir, "%s_chunk%d.sh" % (id, chunk))
            with open(script, "w") as fh:
                fh.write("#!/bin/bash\n\n")
                for c in commands:
                    fh.write(c.cmd + "\n")
            if not os.access(script, os.X_OK):
                mode = stat.S_IMODE(os.stat(script).st_mode)
                os.chmod(script, mode | stat.S_IXUSR)
            submit = Command(script, "%s_chunk%d" % (id, chunk),
                             os.path.join(w_dir, "%s_chunk%d.out"
                                          % (id, chunk)),
                             os.path.join(w_dir, "%s_chunk%d.err"
                                          % (id, chunk)))
            results.append(exe(self.build_command(submit)))
        return results
