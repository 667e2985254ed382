export PRJ_ROOT=${PRJ_ROOT:-../../..}
export PYTHONPATH=$PRJ_ROOT:${PYTHONPATH:-}
export PATH=$PATH:$PRJ_ROOT/egs/utils
