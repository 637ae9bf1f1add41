# The runs that set a cell's bounds, on the machine with the chip:
#   bash benchmark/sets.sh <cell> <out dir> <first seed> <seconds>
# Two sets of six runs on seeds first+1 .. first+6 (the same in both), then
# three traced runs on first+7 .. first+9. Each run's output goes to
# <out dir>/{s1,s2,t}.<i>.{out,err}; `python3 -m benchmark.harness.spreads
# <out dir>` reads them.
W=$1; D=$2; B=$3; SEC=$4
mkdir -p "$D"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for set in 1 2; do for i in 1 2 3 4 5 6; do
  S=$((B + i)); SECONDS=0
  python3 benchmark/run.py --workload "$W" --seed $S --seconds "$SEC" --trace 0 \
    > "$D/s$set.$i.out" 2> "$D/s$set.$i.err"
  echo "rc=$? ${SECONDS}s set $set seed $S"
done; done
for i in 7 8 9; do
  S=$((B + i)); SECONDS=0
  python3 benchmark/run.py --workload "$W" --seed $S --seconds "$SEC" --trace 1 \
    > "$D/t.$i.out" 2> "$D/t.$i.err"
  echo "rc=$? ${SECONDS}s traced seed $S"
done
